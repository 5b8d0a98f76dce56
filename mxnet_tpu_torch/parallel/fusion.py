"""Bucketed gradient fusion (port of ``mxnet_tpu/parallel/fusion.py``, its
in-step half): one all-reduce per bucket lane instead of one per tensor.

* :func:`plan_buckets` packs keys, in the caller's (priority) order,
  into fixed-byte buckets (``max_bytes``, default 25 MB). Segments of
  different dtypes never share a flat buffer, so a bucket holds one
  *lane* per dtype and the result is bit-exact against the per-key
  all-reduce. Arrays above ``bigarray_bound`` elements (default 1e6, the
  reference's bound) travel alone: a one-segment lane is a reshape, not a
  copy.
* :func:`pack_lane` / :func:`unpack_lane` flatten and slice.
* :func:`bucketed_all_reduce` packs each lane, all-reduces it once
  (``parallel.all_reduce``, so it is differentiable like that) and
  unpacks it. Its plan is made once per :func:`plan_signature`; over
  axes that all have size 1 it returns the tensors as they are.

The plan is the JAX package's for the same entries: dtypes go by their
numpy names ("float32", "bfloat16"), whether given as torch dtypes or as
names. The port reads no environment variable: the JAX package's
``MXNET_KVSTORE_BUCKET_BYTES`` and ``MXNET_KVSTORE_BIGARRAY_BOUND`` are
:func:`plan_buckets`' ``max_bytes`` and ``bigarray_bound`` arguments,
with its defaults.

Not ported yet: the sharded weight update (``FlatOptimizer``,
``ShardSlot``) and the store's switches (``fusion_enabled``,
``shard_update_enabled``) and bound (``bigarray_bound()``), whose callers
are the kvstore and the Trainer's store path; each raises
NotImplementedError naming ROADMAP item A7.
"""

import functools

import numpy as np
import torch

__all__ = ["DEFAULT_BUCKET_BYTES", "DEFAULT_BIGARRAY_BOUND", "bucket_bytes",
           "fusion_enabled", "shard_update_enabled", "bigarray_bound",
           "Segment", "Lane", "Bucket", "plan_buckets", "plan_signature",
           "pack_lane", "unpack_lane", "bucketed_all_reduce",
           "FlatOptimizer", "ShardSlot"]

DEFAULT_BUCKET_BYTES = 25 << 20          # ~25 MB, torch-DDP-class default
DEFAULT_BIGARRAY_BOUND = 1_000_000       # elements — the reference default

# itemsize by numpy name; torch dtypes map onto these names
_ITEMSIZE = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2,
             "int64": 8, "int32": 4, "int16": 2, "int8": 1, "uint8": 1,
             "bool": 1}
_TORCH_NAMES = {torch.float64: "float64", torch.float32: "float32",
                torch.bfloat16: "bfloat16", torch.float16: "float16",
                torch.int64: "int64", torch.int32: "int32",
                torch.int16: "int16", torch.int8: "int8",
                torch.uint8: "uint8", torch.bool: "bool"}


def _dtype_name(dtype):
    """A torch dtype, numpy dtype or name as its numpy name."""
    if isinstance(dtype, torch.dtype):
        return _TORCH_NAMES[dtype]
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in _ITEMSIZE:
        raise TypeError("no bucket lane for dtype %r" % (dtype,))
    return name


def bucket_bytes(override=None):
    """Bucket byte budget: ``override`` when given, else 25 MB."""
    return DEFAULT_BUCKET_BYTES if override is None else int(override)


def _store_refusal(name):
    def refuse(*args, **kwargs):
        raise NotImplementedError(
            "fusion.%s belongs to the kvstore and the Trainer's store path, "
            "which come with ROADMAP item A7" % name)
    refuse.__name__ = name
    refuse.__doc__ = ("Not ported: raises naming ROADMAP item A7 (the "
                      "kvstore's fusion switches and sharded update).")
    return refuse


fusion_enabled = _store_refusal("fusion_enabled")
shard_update_enabled = _store_refusal("shard_update_enabled")
bigarray_bound = _store_refusal("bigarray_bound")
FlatOptimizer = _store_refusal("FlatOptimizer")
ShardSlot = _store_refusal("ShardSlot")


# ------------------------------------------------------------ planning --

class Segment(object):
    """One key's slice of a lane's flat buffer."""
    __slots__ = ("key", "shape", "dtype", "size", "offset")

    def __init__(self, key, shape, dtype, size, offset):
        self.key, self.shape, self.dtype = key, tuple(shape), dtype
        self.size, self.offset = size, offset

    def __repr__(self):
        return "Segment(%r, %s, %s, @%d)" % (self.key, self.shape,
                                             self.dtype, self.offset)


class Lane(object):
    """All same-dtype segments of one bucket, flattened back to back.
    Mixed dtypes never share a buffer: concatenating them would force a
    cast and break bit-exactness with the per-key path."""
    __slots__ = ("dtype", "segments", "size")

    def __init__(self, dtype):
        self.dtype = dtype
        self.segments = []
        self.size = 0

    @property
    def nbytes(self):
        return self.size * _ITEMSIZE[self.dtype]


class Bucket(object):
    __slots__ = ("index", "lanes", "nbytes")

    def __init__(self, index):
        self.index = index
        self.lanes = []                  # ordered by first appearance
        self.nbytes = 0

    def _lane(self, dtype):
        for lane in self.lanes:
            if lane.dtype == dtype:
                return lane
        lane = Lane(dtype)
        self.lanes.append(lane)
        return lane

    def add(self, key, shape, dtype):
        lane = self._lane(dtype)
        size = int(np.prod(shape)) if len(shape) else 1
        lane.segments.append(Segment(key, shape, dtype, size, lane.size))
        lane.size += size
        self.nbytes += size * _ITEMSIZE[dtype]


def plan_buckets(entries, max_bytes=None,
                 bigarray_bound=DEFAULT_BIGARRAY_BOUND):
    """Greedy fixed-byte bucketing in the given (priority) order.

    entries: iterable of (key, shape, dtype). A bucket closes when the
    next entry would push it past the byte budget. Arrays above
    ``bigarray_bound`` elements travel alone (the reference's bigarray
    rule): a one-segment lane flattens as a reshape instead of a concat
    copy. Callers pass entries in reverse-registration order so the bucket
    holding the last layers' gradients, ready first in backward, reduces
    first."""
    max_bytes = bucket_bytes(max_bytes)
    buckets = []
    cur = None
    for key, shape, dtype in entries:
        dtype = _dtype_name(dtype)
        size = int(np.prod(shape)) if len(shape) else 1
        nbytes = size * _ITEMSIZE[dtype]
        if size > bigarray_bound:
            solo = Bucket(len(buckets))
            buckets.append(solo)
            solo.add(key, shape, dtype)
            cur = None                   # never append after a bigarray
            continue
        if cur is None or (cur.nbytes and cur.nbytes + nbytes > max_bytes):
            cur = Bucket(len(buckets))
            buckets.append(cur)
        cur.add(key, shape, dtype)
    return buckets


def plan_signature(entries, max_bytes=None,
                   bigarray_bound=DEFAULT_BIGARRAY_BOUND):
    """Hashable identity of a plan."""
    return (bucket_bytes(max_bytes), int(bigarray_bound),
            tuple((k, tuple(s), _dtype_name(d)) for k, s, d in entries))


# ------------------------------------------------------- pack / unpack --

def pack_lane(lane, values):
    """Concat one worker's tensors for this lane into a flat buffer.
    ``values``: key -> tensor."""
    flats = [values[seg.key].reshape(-1) for seg in lane.segments]
    return flats[0] if len(flats) == 1 else torch.cat(flats)


def unpack_lane(flat, lane):
    """Inverse of pack_lane: flat buffer -> {key: tensor} views. A
    single-segment (bigarray) lane is just a reshape."""
    if len(lane.segments) == 1 and lane.segments[0].size == flat.shape[0]:
        seg = lane.segments[0]
        return {seg.key: flat.reshape(seg.shape)}
    return {seg.key: flat[seg.offset:seg.offset + seg.size].reshape(seg.shape)
            for seg in lane.segments}


# ------------------------------------------------------- in-step fusion --

@functools.lru_cache(maxsize=64)
def _cached_plan(signature):
    max_bytes, _, entries = signature
    return plan_buckets(entries, max_bytes)


def bucketed_all_reduce(values, axis_name="dp", max_bytes=None, keys=None,
                        mesh=None):
    """Fused all-reduce: ``values`` is a list of tensors, in priority
    order; each bucket lane is packed, all-reduced once over
    ``axis_name`` (an axis or a tuple of axes) and unpacked, so a step
    issues O(total bytes / bucket bytes) collectives. Returns the
    reduced tensors in input order, bit-exact against ``all_reduce`` of
    each tensor alone. The plan is made once per signature; over axes
    that all have size 1 every all-reduce is the identity, and the
    tensors come back as they are."""
    from . import all_reduce, current_mesh
    if isinstance(axis_name, (tuple, list)) and not axis_name:
        return list(values)
    mesh = mesh or current_mesh()
    if not mesh._axes(axis_name):
        return list(values)
    keys = list(range(len(values))) if keys is None else list(keys)
    by_key = dict(zip(keys, values))
    plan = _cached_plan(plan_signature(
        [(k, tuple(by_key[k].shape), by_key[k].dtype) for k in keys],
        max_bytes))
    out = {}
    for bucket in plan:
        for lane in bucket.lanes:
            red = all_reduce(pack_lane(lane, by_key), axis_name, mesh=mesh)
            out.update(unpack_lane(red, lane))
    return [out[k] for k in keys]
