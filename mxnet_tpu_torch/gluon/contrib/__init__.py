"""gluon.contrib (port of ``mxnet_tpu/gluon/contrib/``; reference:
python/mxnet/gluon/contrib/). ``rnn`` (the convolutional cells,
``LSTMPCell``, ``VariationalDropoutCell``) is here; ``estimator``,
``nn``, ``data`` and ``cnn`` are ROADMAP item A9 and raise
``MXNetError`` naming it.
"""

from ...base import MXNetError
from . import rnn

# the JAX package's other gluon.contrib submodules: name -> its path there
_QUEUED = {"estimator": "gluon/contrib/estimator/",
           "nn": "gluon/contrib/nn/", "data": "gluon/contrib/data/",
           "cnn": "gluon/contrib/cnn/"}


def __getattr__(name):
    if name in _QUEUED:
        raise MXNetError(
            "gluon.contrib.%s is mxnet_tpu/%s, which the PyTorch port has "
            "not ported yet (ROADMAP item A9)" % (name, _QUEUED[name]))
    raise AttributeError(name)
