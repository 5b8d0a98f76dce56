"""mx.contrib.symbol (port of ``mxnet_tpu/contrib/symbol.py``): the
symbolic ``_contrib_*`` namespace, the same functions as
``mx.sym.contrib``."""
from ..symbol import contrib as _c


def __getattr__(item):
    return getattr(_c, item)
