"""Gluon utility functions (port of ``mxnet_tpu/gluon/utils.py``;
reference: python/mxnet/gluon/utils.py): split_data, split_and_load,
clip_global_norm, check_sha1, download and shape_is_known.

Nothing is fetched: ``download`` takes ``file://`` URLs and existing
local paths only, and raises for any other URL.
"""

import os
import hashlib

import numpy as np
import torch

from .. import ndarray as nd
from ..base import MXNetError

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """Splits an NDArray into `num_slice` slices along `batch_axis`
    (gluon/utils.py:34)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices along "
            "axis %d. Use a batch size that's multiple of %d or set "
            "even_split=False to allow uneven partitioning of data."
            % (str(data.shape), num_slice, batch_axis, num_slice))
    if num_slice == 1:
        return [data]
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        begin = i * step
        end = (i + 1) * step if i < num_slice - 1 else size
        slices.append(data.slice_axis(batch_axis, begin, end))
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Splits an NDArray into len(ctx_list) slices and loads each onto one
    context (gluon/utils.py:85). With a single context this is the
    whole batch on it."""
    if not isinstance(data, nd.NDArray):
        data = nd.array(data)
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Rescales NDArrays so that the sum of their 2-norm is smaller than
    max_norm (gluon/utils.py:132)."""
    def _norm(array):
        x = array.reshape((-1,))
        return nd.dot(x, x)
    assert len(arrays) > 0
    total_norm = nd.add_n(*[_norm(arr) for arr in arrays])
    total_norm = nd.sqrt(total_norm)
    total_norm = float(total_norm.asscalar())
    if check_isfinite and not np.isfinite(total_norm):
        import warnings
        warnings.warn(
            UserWarning("nan or inf is detected. Clipping results will be "
                        "undefined."), stacklevel=2)
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        with torch.no_grad():
            for arr in arrays:
                arr._set_data(arr._data * scale)
    return total_norm


def check_sha1(filename, sha1_hash):
    """Checks whether the sha1 hash of the file content matches
    (gluon/utils.py:180)."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    """Download a file from a URL (gluon/utils.py:202). Only file:// URLs
    and existing local paths are supported; any other URL raises."""
    if path is None:
        fname = url.split("/")[-1]
    elif os.path.isdir(path):
        fname = os.path.join(path, url.split("/")[-1])
    else:
        fname = path
    if os.path.exists(fname) and not overwrite and \
            (not sha1_hash or check_sha1(fname, sha1_hash)):
        return fname
    if url.startswith("file://"):
        import shutil
        shutil.copyfile(url[7:], fname)
        return fname
    raise MXNetError(
        "download('%s'): only file:// URLs and existing local paths are "
        "supported; place the file at '%s'" % (url, fname))


def shape_is_known(shape):
    """True when no dimension is unknown (reference gluon/utils.py —
    0/-1 mark deferred dims)."""
    if shape is None:
        return False
    unknown = (-1, 0, None)
    return all(s not in unknown for s in shape)
