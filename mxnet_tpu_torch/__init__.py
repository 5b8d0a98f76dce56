"""PyTorch/CUDA port of the ``mxnet_tpu`` package, for one NVIDIA H100.

The JAX package stays the reference; each module here is named after its
counterpart there. The port so far carries the transformer: its serving
path (the paged continuous-batching server in ``models.serving`` and
greedy ``generate()`` in ``models.transformer``, with RoPE and int8 KV
caches), with the decode-attention kernels written in CUDA C++
(``csrc/decode_attention.cu``: paged decode in fp32/bf16 and int8, and
flash decode),
and its training path (``forward``, ``loss_fn`` and ``make_train_step``
in ``models.transformer``), with the flash-attention forward and
backward kernels (``csrc/flash_attention.cu``), and the forward path
under a mesh (``parallel``: a mesh over a ``torch.distributed`` world,
its collectives, and ring attention with the ring-carry kernel of the
same file). Importing the package needs neither ``nvcc`` nor a GPU:
kernels build at first launch.
"""

from .context import cpu, gpu, resolve_device
from . import kernels, models, parallel

__all__ = ["cpu", "gpu", "resolve_device", "kernels", "models", "parallel"]
