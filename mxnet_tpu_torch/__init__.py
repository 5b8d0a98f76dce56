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
same file); and the imperative core: ``nd`` (the NDArray value type
and the ops of ``ops.elemwise``, ``ops.reduce_ops`` and ``ops.matrix``),
``autograd`` over torch.autograd, and ``rtc``, which compiles CUDA
source at runtime with NVRTC (``CudaModule``) and launches Triton or
plain bodies (``PallasModule``); and the ResNet path: the ``nn`` ops
of ``ops.nn``, ``initializer``, ``symbol`` with ``executor`` and
``cached_op``, ``gluon`` (parameters, blocks, layers, the ResNet model
zoo), ``utils.functionalize_block``, and ``entry`` (``entry()`` and
``build_train_step``, the counterparts of the JAX package's
``__graft_entry__.entry`` and ``bench.build_train_step``, and
``real_data``, that of ``bench.py --real-data``); and data and IO:
``recordio`` (with the native scanner of ``_native``), ``io``'s
iterators, ``image``'s decode, augmenters and iterators,
``gluon.data`` and ``contrib.io``; and the kvstore stack
(``kvstore``, ``kvstore_server``, ``gradient_compression``, the Gluon
``Trainer``'s store path) with the Module front end (``module``/``mod``,
``model``, ``metric``, ``callback``, ``executor_manager``, and
``entry.module_fit``, the counterpart of ``train_imagenet.py``'s
``Module.fit``); and random sampling (``random``, ``ops.random_ops``),
control flow (``control_flow``, ``ops.control_flow_ops``) and the
recurrent nets (``rnn``, ``gluon.rnn``, ``gluon.contrib.rnn``, with
``entry.word_lm`` and ``entry.bucketing_lm``). The default context is ``gpu(0)``:
without a CUDA device it raises; host callers say ``with cpu():``.
Importing the package needs neither ``nvcc``, NVRTC, Triton nor a GPU:
kernels build at first launch.
"""

from .base import MXNetError
from .context import (Context, cpu, current_context, gpu, gpu_memory_info,
                      num_gpus, resolve_device)
from . import (attribute, autograd, engine, kernels, models, name, ndarray,
               observability, ops, parallel, random, registry, rtc,
               storage)
from . import initializer, symbol
from . import executor, cached_op, gluon, utils
from . import lr_scheduler, optimizer
from . import recordio, io, image, contrib
from . import gradient_compression, kvstore, kvstore_server
from . import metric, callback, model, executor_manager, module
from . import control_flow, rnn
from .attribute import AttrScope
from .name import NameManager, Prefix
from .symbol import Symbol

nd = ndarray
sym = symbol
init = initializer
mod = module

__all__ = ["MXNetError", "Context", "cpu", "gpu", "current_context",
           "num_gpus", "gpu_memory_info", "resolve_device", "nd", "ndarray",
           "autograd", "random", "rtc", "ops", "engine", "storage",
           "kernels", "models", "observability", "parallel", "name",
           "attribute", "AttrScope",
           "NameManager", "Prefix", "registry", "initializer", "init",
           "symbol", "sym", "Symbol", "executor", "cached_op", "gluon",
           "utils", "lr_scheduler", "optimizer", "recordio", "io", "image",
           "contrib", "gradient_compression", "kvstore", "kvstore_server",
           "metric", "callback", "model", "executor_manager", "module",
           "mod", "control_flow", "rnn"]

# names of the JAX package's top level that the port has not ported yet:
# name -> (JAX module, ROADMAP item)
_QUEUED = {
    "sparse": ("sparse.py", "A9"),
    "operator": ("operator.py", "A9"),
    "numpy": ("numpy/", "A9"),
    "np": ("numpy/", "A9"),
    "numpy_extension": ("numpy_extension/", "A9"),
    "npx": ("numpy_extension/", "A9"),
    "profiler": ("profiler.py", "A9"),
    "monitor": ("monitor.py", "A9"),
    "Monitor": ("monitor.py", "A9"),
    "visualization": ("visualization.py", "A9"),
    "inspector": ("inspector.py", "A9"),
    "TensorInspector": ("inspector.py", "A9"),
    "libinfo": ("libinfo.py", "A9"),
    "runtime": ("runtime.py", "A9"),
    "library": ("library.py", "A9"),
    "log": ("log.py", "A9"),
    "util": ("util.py", "A9"),
    "torch": ("torch.py", "A9"),
    "test_utils": ("test_utils.py", "A9"),
}


def __getattr__(name):
    if name in _QUEUED:
        module, item = _QUEUED[name]
        raise MXNetError(
            "mx.%s is mxnet_tpu/%s, which the PyTorch port has not ported "
            "yet (ROADMAP item %s)" % (name, module, item))
    raise AttributeError(name)
