"""Base helpers and the exception type (port of ``mxnet_tpu/base.py``).

The user-visible pieces only: ``MXNetError`` and the dtype helpers the
NDArray core uses. There is no C ABI to cross: the
native core is PyTorch.
"""

import numpy as np
import torch


class MXNetError(Exception):
    """Error raised by the port (reference: python/mxnet/base.py:75)."""


# The JAX package runs with 64-bit types off: a 64-bit request there
# yields the 32-bit type, and the port follows it.
_NARROW = {"float64": "float32", "int64": "int32", "uint64": "uint32",
           "complex128": "complex64"}


def dtype_name(dtype):
    """Canonical name of a dtype given as a string, a numpy dtype or
    scalar class, or a ``torch.dtype``."""
    if isinstance(dtype, str):
        return {"bool_": "bool"}.get(dtype, dtype)
    if isinstance(dtype, torch.dtype):
        return str(dtype).split(".")[-1]
    try:
        return np.dtype(dtype).name
    except TypeError:
        return str(dtype)


def torch_dtype(dtype, narrow=True):
    """The ``torch.dtype`` of ``dtype``; with ``narrow``, 64-bit types
    map to their 32-bit ones, as in the JAX package."""
    name = dtype_name(dtype)
    if narrow:
        name = _NARROW.get(name, name)
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise MXNetError("unsupported dtype %r" % (dtype,))
    return dt
