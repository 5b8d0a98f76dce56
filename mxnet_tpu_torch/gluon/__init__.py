"""Gluon — the imperative / hybrid frontend (port of
``mxnet_tpu/gluon/``; reference: python/mxnet/gluon/).

``Parameter``/``ParameterDict``, ``Block``/``HybridBlock``/``SymbolBlock``
(hybridized through ``cached_op``), the ``nn`` layers and the ResNet
family of the ``model_zoo`` are here. ``Trainer``, ``loss`` and ``utils``
wait for ROADMAP item A6, ``data`` for A8, ``rnn`` and ``contrib`` for
A9: each raises ``MXNetError`` naming its item.
"""

from ..base import MXNetError
from . import parameter
from .parameter import Parameter, Constant, ParameterDict

from . import block
from .block import Block, HybridBlock, SymbolBlock

from . import nn
from . import model_zoo

# names of the JAX package's gluon that the port has not ported yet:
# name -> (JAX module, ROADMAP item)
_QUEUED = {
    "Trainer": ("gluon/trainer.py", "A6"),
    "trainer": ("gluon/trainer.py", "A6"),
    "loss": ("gluon/loss.py", "A6"),
    "utils": ("gluon/utils.py", "A6"),
    "split_data": ("gluon/utils.py", "A6"),
    "split_and_load": ("gluon/utils.py", "A6"),
    "clip_global_norm": ("gluon/utils.py", "A6"),
    "data": ("gluon/data/", "A8"),
    "rnn": ("gluon/rnn/", "A9"),
    "contrib": ("gluon/contrib/", "A9"),
}


def __getattr__(name):
    if name in _QUEUED:
        module, item = _QUEUED[name]
        raise MXNetError(
            "gluon.%s is mxnet_tpu/%s, which the PyTorch port has not "
            "ported yet (ROADMAP item %s)" % (name, module, item))
    raise AttributeError(name)
