"""Contrib namespace (port of ``mxnet_tpu/contrib/``; reference:
python/mxnet/contrib/__init__.py). ``io`` (``DataLoaderIter``),
``ndarray`` and ``symbol`` (the ``nd.contrib``/``sym.contrib``
namespaces) are here; each of the JAX package's other contrib submodules
is ROADMAP item A9 and raises ``MXNetError`` naming it.
"""

from ..base import MXNetError
from . import io, ndarray, symbol

__all__ = ["io", "ndarray", "symbol"]

# the JAX package's other contrib submodules: name -> its path there
_QUEUED = {"amp": "contrib/amp/", "onnx": "contrib/onnx/",
           "fold_bn": "contrib/fold_bn.py",
           "quantization": "contrib/quantization.py",
           "svrg_optimization": "contrib/svrg_optimization/",
           "tensorboard": "contrib/tensorboard.py", "text": "contrib/text/",
           "autograd": "contrib/autograd.py",
           "tensorrt": "contrib/tensorrt.py"}


def __getattr__(name):
    if name in _QUEUED:
        raise MXNetError(
            "mx.contrib.%s is mxnet_tpu/%s, which the PyTorch port has not "
            "ported yet (ROADMAP item A9)" % (name, _QUEUED[name]))
    raise AttributeError(name)
