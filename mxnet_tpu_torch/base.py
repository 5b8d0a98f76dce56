"""Base helpers and the exception type (port of ``mxnet_tpu/base.py``).

The user-visible pieces only: ``MXNetError`` and the dtype helpers the
NDArray core uses. There is no C ABI to cross: the
native core is PyTorch.

Dtypes face the user as numpy's, as in the JAX package (``np_dtype``).
numpy has no bfloat16 of its own: where ``ml_dtypes`` is installed its
``bfloat16`` serves, else ``BFLOAT16``, an object that compares equal to
``"bfloat16"`` and to itself.
"""

import numpy as np
import torch


class MXNetError(Exception):
    """Error raised by the port (reference: python/mxnet/base.py:75)."""


# The JAX package runs with 64-bit types off: a 64-bit request there
# yields the 32-bit type, and the port follows it.
_NARROW = {"float64": "float32", "int64": "int32", "uint64": "uint32",
           "complex128": "complex64"}


class _BFloat16Dtype:
    """The dtype of a bfloat16 array where ``ml_dtypes`` is missing."""

    name = "bfloat16"
    itemsize = 2
    kind = "V"

    def __eq__(self, other):
        return isinstance(other, _BFloat16Dtype) or other == "bfloat16"

    def __hash__(self):
        return hash("bfloat16")

    def __repr__(self):
        return "dtype('bfloat16')"

    def __str__(self):
        return "bfloat16"


BFLOAT16 = _BFloat16Dtype()


def _bfloat16():
    """numpy's bfloat16 from ``ml_dtypes``, else ``BFLOAT16``."""
    try:
        import ml_dtypes
    except ImportError:
        return BFLOAT16
    return np.dtype(ml_dtypes.bfloat16)


_NP_DTYPES = {}


def np_dtype(dtype):
    """The numpy dtype of a ``torch.dtype`` (``NDArray.dtype``)."""
    got = _NP_DTYPES.get(dtype)
    if got is None:
        name = str(dtype).split(".")[-1]
        got = _bfloat16() if name == "bfloat16" else np.dtype(name)
        _NP_DTYPES[dtype] = got
    return got


def dtype_name(dtype):
    """Canonical name of a dtype given as a string, a numpy dtype or
    scalar class, or a ``torch.dtype``."""
    if isinstance(dtype, str):
        return {"bool_": "bool"}.get(dtype, dtype)
    if isinstance(dtype, torch.dtype):
        return str(dtype).split(".")[-1]
    if isinstance(dtype, _BFloat16Dtype):
        return "bfloat16"
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
