"""Parallelism primitives (port of ``mxnet_tpu/parallel/__init__.py``):
a mesh of named axes over a ``torch.distributed`` world, and the
collectives the model code calls on it.

The JAX package lays devices out in a ``jax.sharding.Mesh`` and writes
its collectives inside ``shard_map`` (psum, all_gather, psum_scatter,
ppermute). Here every process of the world holds one device and runs the
same program on its own shard, so a mesh maps the world's ranks, in
row-major order as the JAX package reshapes its device list, onto named
axes, and each axis is a process group: the ranks that share every other
coordinate. The collectives take an axis name where the
JAX ones do, and run over that group with NCCL on the GPU or gloo on the
CPU. A mesh whose axes multiply to 1 needs no process group: its
collectives return their input, as ``ppermute`` over a size-1 axis is the
identity.

Axis convention (as the JAX package): 'dp' data, 'tp' tensor, 'pp'
pipeline, 'sp' sequence/context, 'ep' expert parallel.

The collectives are differentiable. Each is a ``torch.autograd.Function``
whose backward is the transpose of the program JAX differentiates under
``shard_map``, where a value is either the same on every rank of an axis
(invariant) or this rank's own (varying): ``all_reduce`` (psum, varying
to invariant) passes its cotangent through; ``all_gather`` (its output
varying, as JAX types it) sums the cotangent over the axis and keeps
this rank's block (``psum_scatter``); ``reduce_scatter`` all-gathers the
cotangent; ``ring_permute`` sends it back ``-shift`` places; and
:func:`pvary` (``lax.pvary``: an invariant value entering a computation
that differs by rank) is the identity forward and all-reduces its
cotangent. So a loss that is the same on every rank gives every rank the
gradient of that one loss, once.

``fusion`` holds the bucketed all-reduce, ``pipeline`` the pipeline
stages and ``elastic`` the elastic membership protocol (shrink, exact
resume and regrow) and the accumulating train step.
"""

import contextlib
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..context import resolve_device

__all__ = ["Mesh", "P", "make_mesh", "current_mesh", "use_mesh", "set_mesh",
           "shard", "replicate", "all_reduce", "all_gather", "reduce_scatter",
           "ring_permute", "pvary", "device_count", "init_distributed",
           "fusion", "bucketed_all_reduce", "elastic"]

_CURRENT_MESH = None


def init_distributed(coordinator=None, num_processes=None, process_id=None,
                     timeout=None):
    """Join a multi-process job, as the JAX package's ``init_distributed``
    does: arguments default to the launcher's ``MXNET_TPU_COORDINATOR``
    (host:port, or an init URL such as ``file:///path``),
    ``MXNET_TPU_NUM_PROC`` and ``MXNET_TPU_PROC_ID``. The backend is NCCL
    when CUDA is available (each process then takes the card of its rank
    modulo the card count) and gloo otherwise. ``timeout`` (seconds) bounds
    a collective before the backend gives up on it (torch's default when
    None); an elastic worker sets it well past the heartbeat staleness
    window, so that NCCL's watchdog does not tear a survivor down before
    its shrink is committed. No-op, returning False, when the job has a
    single process and no coordinator."""
    coordinator = coordinator or os.environ.get("MXNET_TPU_COORDINATOR")
    num_processes = int(num_processes or
                        os.environ.get("MXNET_TPU_NUM_PROC", "1"))
    process_id = int(process_id if process_id is not None
                     else os.environ.get("MXNET_TPU_PROC_ID", "0"))
    if coordinator is None and num_processes == 1:
        return False
    if coordinator is None:
        raise ValueError("a job of %d processes needs a coordinator "
                         "address" % num_processes)
    backend = "gloo"
    if torch.cuda.is_available():
        backend = "nccl"
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    url = coordinator if "://" in coordinator else "tcp://" + coordinator
    kw = {} if timeout is None else \
        {"timeout": datetime.timedelta(seconds=float(timeout))}
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id, **kw)
    return True


def _world():
    """(world size, this process's rank)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def device_count():
    """Devices of the job: one per process of the world."""
    return _world()[0]


class Mesh:
    """The world's ranks laid out on named axes. ``shape`` maps each axis
    name to its size (as the JAX mesh's ``shape``), ``ranks`` is the
    array of global ranks in that shape, and ``device`` is this rank's
    device. Build it with :func:`make_mesh`: every rank of the world must
    do so together, since the axis groups are made then."""

    def __init__(self, sizes, names, device):
        world, rank = _world()
        if int(np.prod(sizes)) != world:
            raise ValueError("mesh axes %s don't cover %d processes"
                             % (dict(zip(names, sizes)), world))
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, (int(s) for s in sizes)))
        self.ranks = np.arange(world).reshape(sizes)
        self.rank = rank
        self.coords = dict(zip(names, np.unravel_index(rank, sizes)))
        self.device = device
        # one process group per axis of size above 1, made by every rank in
        # one order (new_group is collective over the world)
        self._groups = {n: self._make_group(n) for n in names
                        if self.shape[n] > 1}

    @property
    def size(self):
        return int(self.ranks.size)

    def _axes(self, axis_name):
        names = (axis_name,) if isinstance(axis_name, str) else \
            tuple(axis_name)
        for n in names:
            if n not in self.shape:
                raise ValueError("mesh has no axis %r (axes %s)"
                                 % (n, self.axis_names))
        return tuple(n for n in self.axis_names
                     if n in names and self.shape[n] > 1)

    def _make_group(self, axis):
        """The group of ``axis`` that holds this rank (new_group runs for
        every group, on every rank)."""
        moved = np.moveaxis(self.ranks, self.axis_names.index(axis), -1)
        mine = None
        for ranks in moved.reshape(-1, self.shape[axis]):
            group = dist.new_group([int(r) for r in ranks])
            if self.rank in ranks:
                mine = (group, [int(r) for r in ranks])
        return mine

    def axis_size(self, axis_name):
        """Size of an axis (or the product over a tuple of axes)."""
        return int(np.prod([self.shape[n] for n in self._axes(axis_name)]))

    def axis_index(self, axis_name):
        """This rank's coordinate along ``axis_name`` (``lax.axis_index``)."""
        self._axes(axis_name)
        return int(self.coords[axis_name])

    def group(self, axis_name):
        """(process group, its global ranks in axis order) of one axis, or
        None when its size is 1. A tuple of axes may hold at most one axis
        above size 1: only :func:`all_reduce` runs over several."""
        axes = self._axes(axis_name)
        if len(axes) > 1:
            raise ValueError("a collective over the axes %s at once: only "
                             "all_reduce runs over several" % (axes,))
        return self._groups[axes[0]] if axes else None

    def __repr__(self):
        return "Mesh(%s, device=%s)" % (self.shape, self.device)


class P(tuple):
    """A partition spec, as JAX's ``PartitionSpec``: one entry per
    dimension, the mesh axis that splits it (or a tuple of axes) or None
    for a dimension every rank holds whole. ``P("dp", None)`` splits rows
    over dp."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P%s" % (tuple(self),)


def make_mesh(axes=None, device=None):
    """A :class:`Mesh` over the world from an axis-name -> size dict.

    make_mesh({'dp': 4, 'sp': 2}) lays 8 processes out as a 4 x 2 grid.
    A size of -1 is inferred (at most one). Defaults to pure DP over the
    world. ``device`` is this rank's device: by default the current CUDA
    device (raising without one); pass ``"cpu"`` for a gloo world."""
    world, _ = _world()
    if axes is None:
        axes = {"dp": world}
    names = list(axes)
    sizes = [int(s) for s in axes.values()]
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis size may be -1")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = world // known
    return Mesh(sizes, names, resolve_device(device))


def current_mesh():
    """The active mesh (a default all-DP mesh on first use)."""
    global _CURRENT_MESH
    if _CURRENT_MESH is None:
        _CURRENT_MESH = make_mesh()
    return _CURRENT_MESH


def set_mesh(mesh):
    global _CURRENT_MESH
    _CURRENT_MESH = mesh


@contextlib.contextmanager
def use_mesh(mesh):
    global _CURRENT_MESH
    prev = _CURRENT_MESH
    _CURRENT_MESH = mesh
    try:
        yield mesh
    finally:
        _CURRENT_MESH = prev


# ---------------------------------------------------------------------
# Placement: the JAX package's device_put with a PartitionSpec. A rank
# holds its own block, so placing is slicing.
# ---------------------------------------------------------------------

def _spec_axes(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard(x, spec, mesh=None):
    """This rank's block of the global tensor ``x`` under ``spec`` (a
    :class:`P`), on the mesh's device: each dimension is split over the
    axes its entry names, in order, as ``NamedSharding`` splits it."""
    mesh = mesh or current_mesh()
    x = x._data if hasattr(x, "_data") else x
    for dim, entry in enumerate(spec):
        for name in _spec_axes(entry):
            n = mesh.axis_size(name)
            if n == 1:
                continue
            if x.shape[dim] % n:
                raise ValueError("dimension %d of size %d does not split over "
                                 "the %d ranks of axis %r"
                                 % (dim, x.shape[dim], n, name))
            block = x.shape[dim] // n
            x = x.narrow(dim, mesh.axis_index(name) * block, block)
    return x.contiguous().to(mesh.device)


def replicate(x, mesh=None):
    """``x`` as every rank holds it: rank 0's value, broadcast to the
    world, on the mesh's device."""
    mesh = mesh or current_mesh()
    x = (x._data if hasattr(x, "_data") else x).to(mesh.device).clone()
    if mesh.size > 1:
        dist.broadcast(x, int(mesh.ranks.flat[0]))
    return x


# ---------------------------------------------------------------------
# Collectives: each runs over the process group of a mesh axis and
# returns a new tensor, as the JAX collectives return new arrays; over
# axes of size 1 each returns its input. Every rank of the group must
# call it, in the same order, in the forward and in the backward.
# ---------------------------------------------------------------------

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _all_reduce(x, axes, op, mesh):
    out = x.clone()
    for axis in axes:
        dist.all_reduce(out, op=_OPS[op], group=mesh.group(axis)[0])
    return out


def _all_gather(x, entry, axis, tiled):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in entry[1]]
    dist.all_gather(parts, x, group=entry[0])
    return torch.cat(parts, axis) if tiled else torch.stack(parts, axis)


def _block(x, entry, rank, dim):
    n = len(entry[1])
    if x.shape[dim] % n:
        raise ValueError("dimension %d of size %d does not split over %d "
                         "ranks" % (dim, x.shape[dim], n))
    return x.chunk(n, dim)[entry[1].index(rank)].contiguous()


def _permute(x, entry, rank, shift):
    group, ranks = entry
    n = len(ranks)
    i = ranks.index(rank)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, ranks[(i + shift) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(i - shift) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, op, mesh):
        ctx.op = op
        return _all_reduce(x, axes, op, mesh)

    @staticmethod
    def backward(ctx, g):
        if ctx.op != "sum":
            raise RuntimeError("all_reduce(op=%r) has no gradient (nor has "
                               "lax.pmax)" % ctx.op)
        return g, None, None, None


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axes, "sum", ctx.mesh), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, entry, axis, tiled, rank):
        ctx.entry, ctx.axis, ctx.tiled, ctx.rank = entry, axis, tiled, rank
        return _all_gather(x, entry, axis, tiled)

    @staticmethod
    def backward(ctx, g):
        total = g.contiguous().clone()
        dist.all_reduce(total, group=ctx.entry[0])
        if ctx.tiled:
            return _block(total, ctx.entry, ctx.rank, ctx.axis), None, None, \
                None, None
        return total.select(ctx.axis, ctx.entry[1].index(ctx.rank)), None, \
            None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, entry, dim, rank):
        ctx.entry, ctx.dim = entry, dim
        total = x.clone()
        dist.all_reduce(total, group=entry[0])
        return _block(total, entry, rank, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.entry, ctx.dim, True), None, None, None


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, entry, rank, shift):
        ctx.entry, ctx.rank, ctx.shift = entry, rank, shift
        return _permute(x, entry, rank, shift)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.entry, ctx.rank, -ctx.shift), None, None, None


def all_reduce(x, axis_name="dp", op="sum", mesh=None):
    """psum (or pmax with ``op="max"``, which has no gradient) over a
    mesh axis, or over a tuple of axes one axis after another. Its
    backward passes the cotangent through: the output is the same on
    every rank, and so is its cotangent. An empty tuple of axes returns
    ``x``."""
    if isinstance(axis_name, (tuple, list)) and not axis_name:
        return x
    mesh = mesh or current_mesh()
    axes = mesh._axes(axis_name)
    if not axes:
        return x
    return _AllReduce.apply(x, axes, op, mesh)


def pvary(x, axis_name, mesh=None):
    """``x``, the same on every rank of the axes, entering a computation
    that differs by rank (``lax.pvary``): the identity, whose backward
    all-reduces the cotangent over the axes (Megatron's f). Place it where
    a replicated activation meets sharded weights, or a rank's own
    tokens. An empty tuple of axes returns ``x``."""
    if isinstance(axis_name, (tuple, list)) and not axis_name:
        return x
    mesh = mesh or current_mesh()
    axes = mesh._axes(axis_name)
    if not axes:
        return x
    return _PVary.apply(x, axes, mesh)


def all_gather(x, axis_name="dp", axis=0, tiled=True, mesh=None):
    """The axis's shards in axis order, concatenated along ``axis``
    (``tiled``) or stacked on a new leading ``axis``. Its backward sums
    the cotangent over the axis and keeps this rank's block."""
    mesh = mesh or current_mesh()
    entry = mesh.group(axis_name)
    if entry is None:
        return x if tiled else x.unsqueeze(axis)
    return _AllGather.apply(x, entry, axis, tiled, mesh.rank)


def reduce_scatter(x, axis_name="dp", scatter_dimension=0, mesh=None):
    """psum over the axis, then this rank's block of ``scatter_dimension``
    (``psum_scatter(..., tiled=True)``), as an all-reduce and a slice:
    gloo has no reduce-scatter. Its backward all-gathers the cotangent."""
    mesh = mesh or current_mesh()
    entry = mesh.group(axis_name)
    if entry is None:
        return x
    return _ReduceScatter.apply(x, entry, scatter_dimension, mesh.rank)


def ring_permute(x, axis_name, shift=1, mesh=None):
    """Send ``x`` ``shift`` places around the axis's ring and return what
    arrives from ``shift`` places back (``ppermute`` with the permutation
    i -> (i + shift) mod n) — the building block of ring attention and
    of the pipeline's ticks. Its backward sends the cotangent ``-shift``
    places."""
    mesh = mesh or current_mesh()
    entry = mesh.group(axis_name)
    if entry is None or shift % len(entry[1]) == 0:
        return x
    return _RingPermute.apply(x, entry, mesh.rank, shift)


# the bucketed all-reduce (one all-reduce per ~25 MB bucket lane instead
# of one per tensor) — importable as mxnet_tpu_torch.parallel.fusion; the
# entry point re-exported here for train-step authors
from . import fusion                                    # noqa: E402
from .fusion import bucketed_all_reduce                 # noqa: E402,F401
# the elastic membership protocol and the accumulating train step
from . import elastic                                   # noqa: E402,F401
