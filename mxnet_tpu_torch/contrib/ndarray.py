"""mx.contrib.ndarray (port of ``mxnet_tpu/contrib/ndarray.py``): the
``_contrib_*`` operator namespace, the same functions as
``mx.nd.contrib`` (the reference's contrib/ndarray.py re-exports the
generated contrib module)."""
from ..ndarray import contrib as _c


def __getattr__(item):
    return getattr(_c, item)
