"""Legacy symbolic RNN API (`mx.rnn`; port of ``mxnet_tpu/rnn/``).

Reference: python/mxnet/rnn/ — the pre-Gluon cell stack used by the
symbolic examples (example/rnn/bucketing). Cells compose raw Symbols;
`unroll` builds the time-major graph that BucketingModule binds per
bucket. The Gluon-era equivalents live in ``gluon.rnn``.
"""

from .rnn_cell import (RNNParams, BaseRNNCell, RNNCell, LSTMCell, GRUCell,
                       FusedRNNCell, SequentialRNNCell, BidirectionalCell,
                       DropoutCell, ModifierCell, ZoneoutCell, ResidualCell)
from .rnn import (save_rnn_checkpoint, load_rnn_checkpoint,
                  do_rnn_checkpoint)
from .io import BucketSentenceIter, encode_sentences
