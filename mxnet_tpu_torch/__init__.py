"""PyTorch/CUDA port of the ``mxnet_tpu`` package, for one NVIDIA H100.

The JAX package stays the reference; each module here is named after its
counterpart there. The port so far carries the transformer: its serving
path (the paged continuous-batching server in ``models.serving`` and
greedy ``generate()`` in ``models.transformer``), with the two
decode-attention kernels written in CUDA C++ (``csrc/decode_attention.cu``),
and its training path (``forward``, ``loss_fn`` and ``make_train_step``
in ``models.transformer``), with the flash-attention forward and
backward kernels (``csrc/flash_attention.cu``). Importing the package
needs neither ``nvcc`` nor a GPU: kernels build at first launch.
"""

from .context import cpu, gpu, resolve_device
from . import kernels, models

__all__ = ["cpu", "gpu", "resolve_device", "kernels", "models"]
