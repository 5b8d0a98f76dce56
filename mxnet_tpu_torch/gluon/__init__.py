"""Gluon — the imperative / hybrid frontend (port of
``mxnet_tpu/gluon/``; reference: python/mxnet/gluon/).

``Parameter``/``ParameterDict``, ``Block``/``HybridBlock``/``SymbolBlock``
(hybridized through ``cached_op``), the ``nn`` layers, the ResNet family
of the ``model_zoo``, ``Trainer``, ``loss``, ``utils`` and ``data`` (with
``data.vision``) are here. ``rnn`` and ``contrib`` wait for ROADMAP item
A9: each raises ``MXNetError`` naming it.
"""

from ..base import MXNetError
from . import parameter
from .parameter import Parameter, Constant, ParameterDict

from . import block
from .block import Block, HybridBlock, SymbolBlock

from . import nn
from . import model_zoo

from . import trainer
from .trainer import Trainer

from . import loss
from . import utils
from .utils import split_data, split_and_load, clip_global_norm

from . import data

# names of the JAX package's gluon that the port has not ported yet:
# name -> (JAX module, ROADMAP item)
_QUEUED = {
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
