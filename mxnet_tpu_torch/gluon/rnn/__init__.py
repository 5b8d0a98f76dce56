"""Recurrent layers and cells (port of ``mxnet_tpu/gluon/rnn/``)."""

from .rnn_cell import *
from .rnn_layer import *
