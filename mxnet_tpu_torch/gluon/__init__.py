"""Gluon — the imperative / hybrid frontend (port of
``mxnet_tpu/gluon/``; reference: python/mxnet/gluon/).

``Parameter``/``ParameterDict``, ``Block``/``HybridBlock``/``SymbolBlock``
(hybridized through ``cached_op``), the ``nn`` layers, the ResNet family
of the ``model_zoo``, ``Trainer``, ``loss``, ``utils``, ``data`` (with
``data.vision``), ``rnn`` (cells and the fused layers) and ``contrib``
(whose ``rnn`` is ported; its other submodules name ROADMAP item A9) are
here.
"""

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
from . import rnn
from . import contrib

