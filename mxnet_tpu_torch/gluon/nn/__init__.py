"""Gluon neural network layers (port of ``mxnet_tpu/gluon/nn/``;
reference: python/mxnet/gluon/nn/)."""

from .activations import *
from .basic_layers import *
from .conv_layers import *

from . import activations
from . import basic_layers
from . import conv_layers
