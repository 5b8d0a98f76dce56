"""Bucketed gradient fusion (port of ``mxnet_tpu/parallel/fusion.py``):
one collective per bucket lane instead of one per tensor, and the sharded
weight update.

* :func:`plan_buckets` packs keys, in the caller's (priority) order,
  into fixed-byte buckets (``max_bytes``, default 25 MB). Segments of
  different dtypes never share a flat buffer, so a bucket holds one
  *lane* per dtype and the result is bit-exact against the per-key
  all-reduce. Arrays above ``bigarray_bound`` elements (default 1e6, the
  reference's bound) travel alone: a one-segment lane is a reshape, not a
  copy.
* :func:`pack_lane` / :func:`unpack_lane` flatten and slice;
  ``pack_lane(pad_to=)`` zero-pads the tail for the sharded update.
* :func:`bucketed_all_reduce` packs each lane, all-reduces it once
  (``parallel.all_reduce``, so it is differentiable like that) and
  unpacks it. Its plan is made once per :func:`plan_signature`; over
  axes that all have size 1 it returns the tensors as they are.
* :class:`FlatOptimizer` and :class:`ShardSlot` are the sharded weight
  update the kvstore runs when ``shard_update`` is on: per bucket lane,
  reduce-scatter the flat gradient over the ranks of the store's world,
  update this rank's 1/N of the flat master weight and optimizer state,
  and all-gather the new weight. The JAX package maps a ShardSlot onto N
  devices of one process; here its N is the world's ranks.

The plan is the JAX package's for the same entries: dtypes go by their
numpy names ("float32", "bfloat16"), whether given as torch dtypes or as
names. The port reads no environment variable: the JAX package's
``MXNET_KVSTORE_FUSION`` (on), ``MXNET_KVSTORE_SHARD_UPDATE`` (off),
``MXNET_KVSTORE_BUCKET_BYTES`` (25 MB) and ``MXNET_KVSTORE_BIGARRAY_BOUND``
(1e6) are arguments with those defaults: of :func:`fusion_enabled`,
:func:`shard_update_enabled`, :func:`bucket_bytes` and
:func:`bigarray_bound` here, and of ``kvstore.create``, whose stores
carry them.
"""

import functools
import math

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
_TORCH_OF = {name: dt for dt, name in _TORCH_NAMES.items()}


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


def fusion_enabled(override=None):
    """Whether the Trainer's and Module's store paths go bucketed: on
    unless ``override`` says otherwise (``MXNET_KVSTORE_FUSION``)."""
    return True if override is None else bool(override)


def shard_update_enabled(override=None):
    """Whether a bucket lowers to reduce-scatter -> sharded update ->
    all-gather: off unless ``override`` says otherwise
    (``MXNET_KVSTORE_SHARD_UPDATE``)."""
    return False if override is None else bool(override)


def bigarray_bound(override=None):
    """Elements above which an array travels alone
    (``MXNET_KVSTORE_BIGARRAY_BOUND``, the reference's 1e6)."""
    return DEFAULT_BIGARRAY_BOUND if override is None else int(override)


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

def pack_lane(lane, values, pad_to=None):
    """Concat one worker's tensors for this lane into a flat buffer.
    ``values``: key -> tensor. ``pad_to`` zero-pads the tail (the sharded
    update needs a length that the world's size divides)."""
    flats = [values[seg.key].reshape(-1) for seg in lane.segments]
    flat = flats[0] if len(flats) == 1 else torch.cat(flats)
    if pad_to is not None and pad_to > lane.size:
        flat = torch.cat([flat, flat.new_zeros(pad_to - lane.size)])
    return flat


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


# ---------------------------------------------- sharded weight update --

class FlatOptimizer(object):
    """Flat elementwise form of an Optimizer's update rule.

    The sharded update applies the optimizer to a 1/N shard of a flat
    bucket, so the rule must be elementwise over the flat buffer with
    scalar (or per-element) hyperparameters. The rules are the port's
    ``optimizer.py`` ones, in the same order of operations: sgd
    (+momentum), nag and adam. ``supports`` returns None for anything
    else, and the store then updates key by key on the replicated
    aggregate.
    """

    RULES = {
        "sgd": 1, "nag": 1, "adam": 2,          # name -> n state buffers
    }

    def __init__(self, optimizer, name):
        self.optimizer = optimizer
        self.name = name
        self.n_states = 0 if name in ("sgd", "nag") \
            and not getattr(optimizer, "momentum", 0.0) \
            else self.RULES[name]

    @classmethod
    def supports(cls, optimizer):
        """A FlatOptimizer when the rule is shardable, else None.
        Subclass instances are refused: an override of update() or
        _apply_rule would silently part from the flat rule."""
        if optimizer is None:
            return None
        for name, klass in (("sgd", "SGD"), ("nag", "NAG"),
                            ("adam", "Adam")):
            mod = type(optimizer).__module__
            if type(optimizer).__name__ == klass \
                    and mod.endswith("optimizer"):
                return cls(optimizer, name)
        return None

    def step_scalars(self, t):
        """(lr, wd, rescale_grad) of step ``t``, as fp32 numbers."""
        o = self.optimizer
        lr = o.learning_rate
        if self.name == "adam":
            lr = lr * math.sqrt(1.0 - o.beta2 ** t) / (1.0 - o.beta1 ** t)
        return (np.float32(lr), np.float32(o.wd),
                np.float32(o.rescale_grad))

    def extra_scalars(self):
        o = self.optimizer
        if self.name == "adam":
            return (np.float32(o.beta1), np.float32(o.beta2),
                    np.float32(o.epsilon))
        return (np.float32(getattr(o, "momentum", 0.0)),)

    @property
    def clip(self):
        c = self.optimizer.clip_gradient
        return None if c is None else float(c)

    def apply(self, w, g, states, lr, wd, extra, clip, lr_mult=None,
              wd_mult=None):
        """The elementwise rule over flat tensors (the optimizer's
        _sgd_update, _sgd_mom_update, _nag_mom_update and _adam_update,
        element for element); returns (new w, new states)."""
        lr, wd = float(lr), float(wd)
        if clip is not None:
            g = torch.clamp(g, -clip, clip)
        if lr_mult is not None:
            lr = lr * lr_mult
        if wd_mult is not None:
            wd = wd * wd_mult
        if self.name == "adam":
            beta1, beta2, eps = (float(x) for x in extra)
            m, v = states
            g = g + wd * w
            m = beta1 * m + (1.0 - beta1) * g
            v = beta2 * v + (1.0 - beta2) * g * g
            return w - lr * m / (torch.sqrt(v) + eps), (m, v)
        momentum = float(extra[0])
        if not self.n_states:
            return w - lr * (g + wd * w), ()
        (mom,) = states
        if self.name == "nag":
            g = g + wd * w
            mom = momentum * mom + g
            return w - lr * (momentum * mom + g), (mom,)
        mom = momentum * mom - lr * (g + wd * w)
        return w + mom, (mom,)


def _world_of(group):
    """(size, rank) of ``group`` (None: the default world); a world of
    one when no process group is initialised."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def _is_nccl(group):
    return torch.distributed.get_backend(group) == "nccl"


def _reduce_scatter(flat, n, rank, group):
    """This rank's 1/n block of the sum of ``flat`` over the group."""
    dist = torch.distributed
    flat = flat.contiguous()
    if _is_nccl(group):
        out = flat.new_empty(flat.shape[0] // n)
        dist.reduce_scatter_tensor(out, flat, group=group)
        return out
    total = flat.clone()
    dist.all_reduce(total, group=group)
    return total.chunk(n)[rank].clone()


def _all_gather_flat(shard, n, group):
    dist = torch.distributed
    shard = shard.contiguous()
    if _is_nccl(group):
        out = shard.new_empty(shard.shape[0] * n)
        dist.all_gather_into_tensor(out, shard, group=group)
        return out
    parts = [torch.empty_like(shard) for _ in range(n)]
    dist.all_gather(parts, shard, group=group)
    return torch.cat(parts)


def _host(t):
    from ..ndarray import NDArray
    return NDArray(t).asnumpy()


class ShardSlot(object):
    """Persistent sharded state of one bucket lane: this rank's 1/N of
    the flat master weight and of the optimizer state, N the ranks of
    ``group`` (None: the default world; a world of one when no process
    group is initialised). Per-replica bytes for master and state are
    total/N, the (N-1)/N cut of "Automatic Cross-Replica Sharding of
    Weight Update in Data-Parallel Training" (PAPERS.md)."""

    def __init__(self, lane, group, weights, flat_opt, t0=0):
        self.lane = lane
        self.group = group
        self.n, self.rank = _world_of(group)
        self.l_pad = -(-lane.size // self.n) * self.n   # ceil to n
        self.shard = self.l_pad // self.n
        self.flat_opt = flat_opt
        self.t = int(t0)
        # master weight: fp32 when the optimizer runs multi-precision on
        # a bf16 lane (the fp32 master state the paper shards)
        self.master_fp32 = bool(
            getattr(flat_opt.optimizer, "multi_precision", False)
            and lane.dtype == "bfloat16")
        self.mdtype = torch.float32 if self.master_fp32 \
            else _TORCH_OF[lane.dtype]
        flat_w = pack_lane(lane, weights, pad_to=self.l_pad)
        self.device = flat_w.device
        self.flat_w = self._mine(flat_w.to(self.mdtype))
        self.states = tuple(torch.zeros(self.shard, dtype=self.mdtype,
                                        device=self.device)
                            for _ in range(flat_opt.n_states))
        self._mults = self._build_mults()

    def _mine(self, full):
        lo = self.rank * self.shard
        return full[lo:lo + self.shard].clone()

    def _build_mults(self):
        """This rank's block of the per-element lr/wd multipliers, made
        only when some segment's multiplier differs from 1 (Module's
        per-parameter tables); the common case stays scalar."""
        o = self.flat_opt.optimizer
        idxs = [int(s.key) if str(s.key).isdigit() else s.key
                for s in self.lane.segments]
        try:
            lrs = [o._get_lr(i) for i in idxs]
            wds = [o._get_wd(i) for i in idxs]
        except Exception:
            return None
        base_lr = o.learning_rate or 1.0
        lr_r = [l / base_lr if base_lr else 1.0 for l in lrs]
        wd_r = [w / o.wd if o.wd else 1.0 for w in wds]
        if all(abs(r - 1.0) < 1e-12 for r in lr_r + wd_r):
            return None
        lr_vec = np.ones(self.l_pad, np.float32)
        wd_vec = np.ones(self.l_pad, np.float32)
        for seg, lm, wm in zip(self.lane.segments, lr_r, wd_r):
            lr_vec[seg.offset:seg.offset + seg.size] = lm
            wd_vec[seg.offset:seg.offset + seg.size] = wm
        return tuple(self._mine(torch.from_numpy(v).to(self.device))
                     for v in (lr_vec, wd_vec))

    @property
    def state_bytes_total(self):
        per = self.l_pad * torch.empty((), dtype=self.mdtype).element_size()
        return per * (len(self.states) + (1 if self.master_fp32 else 0))

    @property
    def state_bytes_per_replica(self):
        return self.state_bytes_total // self.n

    def step(self, per_worker_flats):
        """One sharded update from this rank's per-worker flat gradients
        (each padded to l_pad): their sum is reduce-scattered over the
        world, this rank updates its block, and the new flat weight comes
        back whole (the all-gather), in the lane's dtype."""
        self.t += 1
        g = per_worker_flats[0]
        for f in per_worker_flats[1:]:
            g = g + f
        if self.n > 1:
            g = _reduce_scatter(g, self.n, self.rank, self.group)
        lr, wd, rescale = self.flat_opt.step_scalars(self.t)
        g = g.to(self.mdtype) * float(rescale)
        lr_mult, wd_mult = self._mults if self._mults is not None \
            else (None, None)
        self.flat_w, self.states = self.flat_opt.apply(
            self.flat_w, g, self.states, lr, wd,
            self.flat_opt.extra_scalars(), self.flat_opt.clip, lr_mult,
            wd_mult)
        gathered = self.flat_w if self.n == 1 else \
            _all_gather_flat(self.flat_w, self.n, self.group)
        if self.master_fp32:
            gathered = gathered.to(_TORCH_OF[self.lane.dtype])
        return gathered

    # ------------------------------------------------- state (de)hydrate --
    def _whole(self, t):
        return t if self.n == 1 else _all_gather_flat(t, self.n, self.group)

    def get_state(self):
        """Host snapshot of the whole lane for save_optimizer_states
        (every rank of the world calls it: it gathers the blocks)."""
        return {"t": self.t,
                "flat_w": _host(self._whole(self.flat_w)),
                "states": [_host(self._whole(s)) for s in self.states]}

    def set_state(self, snap):
        def block(a):
            t = torch.from_numpy(np.asarray(a, np.float32)
                                 if np.asarray(a).dtype.name == "bfloat16"
                                 else np.asarray(a))
            return self._mine(t.to(device=self.device, dtype=self.mdtype))
        self.t = int(snap["t"])
        self.flat_w = block(snap["flat_w"])
        self.states = tuple(block(s) for s in snap["states"])
