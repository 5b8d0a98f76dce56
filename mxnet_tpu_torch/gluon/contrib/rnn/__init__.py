"""Contrib recurrent cells (port of ``mxnet_tpu/gluon/contrib/rnn/``;
reference: gluon/contrib/rnn/)."""
from .conv_rnn_cell import *  # noqa: F401,F403
from .rnn_cell import LSTMPCell, VariationalDropoutCell  # noqa: F401
from . import conv_rnn_cell, rnn_cell

__all__ = list(conv_rnn_cell.__all__) + list(rnn_cell.__all__)
