"""KVStore, the data-parallel communication layer (port of
``mxnet_tpu/kvstore.py``; reference: include/mxnet/kvstore.h:59-411,
src/kvstore/kvstore.cc:40-75, python/mxnet/kvstore.py:97-635).

* ``local`` / ``device``: one process. Values pushed from several workers
  (a list per key) are summed on their device.
* ``dist_sync`` (``dist_device_sync``, ``dist``, ``dist_tpu_sync``): the
  JAX package's ``KVStoreTPUSync`` over a ``torch.distributed`` world,
  the one ``parallel.init_distributed`` joined (NCCL on the GPU), or a
  world of one when none is initialised. A push sums the rank's own list
  and all-reduces the sum across the world, so every rank holds the same
  aggregate and applies the same update; there is no server role.
  ``rank``/``num_workers`` are the world's. The asynchronous parameter
  server (``dist_async``) is refused, as in the JAX package.

``update_on_kvstore`` (kvstore_dist_server.h ApplyUpdates): with an
optimizer set (``set_optimizer``/``set_updater``) a push updates the
stored weight and a pull returns it; without one a push stores the
aggregate and a pull returns that.

``pushpull_fused`` packs keys, in the given (priority) order, into
fixed-byte buckets (``parallel.fusion``) and aggregates each bucket lane
once. With ``shard_update`` on, a world of more than one rank and an
sgd/nag/adam optimizer, a lane lowers to reduce-scatter -> a 1/N sharded
update (``fusion.ShardSlot``) -> all-gather. ``dispatch_stats`` counts
the collectives, keys, buckets and sharded updates.

The JAX package's environment knobs are arguments of :func:`create` and
the store classes, with its defaults: ``fusion`` (on),
``shard_update`` (off), ``bucket_bytes`` (25 MB) and ``bigarray_bound``
(1e6 elements). Its observability, chaos, watchdog, integrity and memory
budget hooks are not ported. Sparse storage waits for ROADMAP A9:
``row_sparse_pull`` writes the rows into a dense ``out``.
"""

import pickle

import torch

from . import optimizer as opt
from .base import MXNetError
from .gradient_compression import GradientCompression
from .ndarray import NDArray
from .parallel import fusion as _fusion

__all__ = ["KVStore", "KVStoreLocal", "KVStoreDevice", "KVStoreTPUSync",
           "create"]


def _key_str(key):
    return str(key)


def _sum_n(datas):
    out = datas[0]
    for x in datas[1:]:
        out = out + x
    return out


class KVStore(object):
    """Base single-process store (python/mxnet/kvstore.py:97)."""

    def __init__(self, fusion=True, shard_update=False, bucket_bytes=None,
                 bigarray_bound=None):
        self._store = {}          # key -> NDArray (aggregate or weight)
        self._updater = None
        self._optimizer = None
        self._gc = GradientCompression()
        self._residuals = {}      # (key, worker index) -> flat residual
        self._barrier_count = 0
        self._fusion_plans = {}   # plan signature -> list[Bucket]
        self._shard_slots = {}    # (bucket index, lane dtype) -> ShardSlot
        self._pending_shard_state = None
        self.fusion = _fusion.fusion_enabled(fusion)
        self.shard_update = _fusion.shard_update_enabled(shard_update)
        self.bucket_bytes = _fusion.bucket_bytes(bucket_bytes)
        self.bigarray_bound = _fusion.bigarray_bound(bigarray_bound)
        self.dispatch_stats = {"collectives": 0, "keys": 0, "buckets": 0,
                               "shard_updates": 0}

    def reset_dispatch_stats(self):
        for k in self.dispatch_stats:
            self.dispatch_stats[k] = 0

    def _count(self, name, delta=1):
        self.dispatch_stats[name] += delta

    # ------------------------------------------------------------- init --
    def init(self, key, value):
        """Initialize key(s) once (kvstore.py:141)."""
        keys, values = self._normalize(key, value)
        for k, v in zip(keys, values):
            if k in self._store:
                continue
            self._store[k] = v[0].copy() if isinstance(v, (list, tuple)) \
                else v.copy()

    def _normalize(self, key, value):
        single = not isinstance(key, (list, tuple))
        keys = [key] if single else list(key)
        values = [value] if single else list(value)
        return [_key_str(k) for k in keys], values

    # -------------------------------------------------------- push/pull --
    def _maybe_compress(self, k, datas):
        """Each worker's value through quantize -> dequantize with its
        error-feedback residual (the reference's worker-side Quantize and
        receiver-side Dequantize around the wire)."""
        if not self._gc.active:
            return datas
        outs = []
        for i, d in enumerate(datas):
            rkey = (k, i)
            residual = self._residuals.get(rkey)
            if residual is None:
                residual = self._gc.init_residual(d.shape, device=d.device)
            recon, residual = self._gc.compress_decompress(d, residual)
            self._residuals[rkey] = residual
            outs.append(recon.to(d.dtype))
        return outs

    def _aggregate(self, k, datas):
        """Sum the workers' tensors on their device (comm.h CommCPU /
        CommDevice reduce); the dist store adds the world's all-reduce."""
        return _sum_n(datas)

    def push(self, key, value, priority=0):
        """Aggregate values (kvstore.py:234); ``priority`` is accepted for
        API parity."""
        keys, values = self._normalize(key, value)
        for k, v in zip(keys, values):
            vlist = v if isinstance(v, (list, tuple)) else [v]
            datas = self._maybe_compress(
                k, [x._data.detach() for x in vlist])
            self._count("collectives")
            self._count("keys")
            agg = NDArray(self._aggregate(k, datas), vlist[0]._ctx)
            if self._updater is not None:
                if k not in self._store:
                    raise ValueError("Please initialize key %s first" % k)
                # the ApplyUpdates path (kvstore_dist_server.h:346)
                self._updater(self._opt_index(k), agg, self._store[k])
            else:
                self._store[k] = agg

    @staticmethod
    def _pull_into(src, dst):
        """Rebind the destination to the stored value, in the
        destination's dtype and on its device."""
        dst._set_data(src._data.to(device=dst._data.device,
                                   dtype=dst._data.dtype))

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Broadcast the current value into ``out`` (kvstore.py:318)."""
        assert out is not None
        keys, outs = self._normalize(key, out)
        for k, o in zip(keys, outs):
            if k not in self._store:
                raise ValueError("Please initialize key %s first" % k)
            for dst in (o if isinstance(o, (list, tuple)) else [o]):
                self._pull_into(self._store[k], dst)

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out, priority)

    # ------------------------------------------------- fused push/pull --
    def supports_shard_update(self):
        """Whether buckets can lower to reduce-scatter -> sharded update
        -> all-gather (needs a world of more than one rank)."""
        return False

    def pushpull_fused(self, key, value, out=None, bucket_bytes=None):
        """Bucketed fused push + pull: group the keys, in the given
        (priority) order, into fixed-byte buckets and aggregate each
        bucket's dtype lane once instead of each key (comm.h key
        grouping; torch-DDP bucket semantics).

        value: per key, an NDArray or a list of per-worker NDArrays (the
        same worker count on every key). Per bucket:

        * no updater: the lane's aggregate is stored and, when ``out`` is
          given, written back to the outs, exactly like push + pull;
        * an updater: the aggregate updates the stored weight. With
          ``shard_update`` on (and a supported optimizer) the bucket runs
          as reduce-scatter -> 1/N sharded update -> all-gather;
          otherwise the updater applies key by key on the aggregate
          (bit-exact with the per-key push). ``out`` then receives the
          updated weights.
        """
        keys, values = self._normalize(key, value)
        vlists = [list(v) if isinstance(v, (list, tuple)) else [v]
                  for v in values]
        nw = len(vlists[0])
        if any(len(v) != nw for v in vlists):
            raise ValueError(
                "pushpull_fused requires the same worker count on "
                "every key")
        outs = None
        if out is not None:
            okeys, outs_n = self._normalize(key, out)
            assert okeys == keys
            outs = {k: (o if isinstance(o, (list, tuple)) else [o])
                    for k, o in zip(okeys, outs_n)}
        datas = {k: self._maybe_compress(k, [x._data.detach() for x in vl])
                 for k, vl in zip(keys, vlists)}
        ctxs = {k: vl[0]._ctx for k, vl in zip(keys, vlists)}
        entries = [(k, tuple(vl[0].shape), vl[0]._data.dtype)
                   for k, vl in zip(keys, vlists)]
        max_bytes = self.bucket_bytes if bucket_bytes is None \
            else bucket_bytes
        sig = _fusion.plan_signature(entries, max_bytes, self.bigarray_bound)
        plan = self._fusion_plans.get(sig)
        if plan is None:
            plan = self._fusion_plans[sig] = _fusion.plan_buckets(
                entries, max_bytes, self.bigarray_bound)
        flat_opt = None
        if self._updater is not None and self.shard_update \
                and self.supports_shard_update():
            flat_opt = _fusion.FlatOptimizer.supports(self._optimizer)
        self._count("keys", len(keys))
        for bucket in plan:
            self._count("buckets")
            for lane in bucket.lanes:
                self._fused_lane(bucket, lane, datas, ctxs, outs, flat_opt,
                                 nw)

    def _fused_lane(self, bucket, lane, datas, ctxs, outs, flat_opt, nw):
        slot = None
        if flat_opt is not None:
            slot = self._shard_slot(bucket, lane, flat_opt)
        pad = slot.l_pad if slot is not None else None
        per_worker = [
            _fusion.pack_lane(lane, {s.key: datas[s.key][w]
                                    for s in lane.segments}, pad_to=pad)
            for w in range(nw)]
        if slot is not None:
            # reduce-scatter -> sharded update -> all-gather: 2
            # collectives however many keys ride the bucket
            for seg in lane.segments:
                self._optimizer._update_count(self._opt_index(seg.key))
            news = _fusion.unpack_lane(slot.step(per_worker), lane)
            self._count("collectives", 2)
            self._count("shard_updates")
            for seg in lane.segments:
                self._store[seg.key]._set_data(news[seg.key])
        else:
            self._count("collectives")
            agg_flat = self._aggregate("__fused_b%d" % bucket.index,
                                       per_worker)
            news = _fusion.unpack_lane(agg_flat, lane)
            for seg in lane.segments:
                k = seg.key
                agg = NDArray(news[k], ctxs[k])
                if self._updater is not None:
                    if k not in self._store:
                        raise ValueError(
                            "Please initialize key %s first" % k)
                    self._updater(self._opt_index(k), agg, self._store[k])
                else:
                    self._store[k] = agg
        if outs is not None:
            for seg in lane.segments:
                for dst in outs[seg.key]:
                    self._pull_into(self._store[seg.key], dst)

    @staticmethod
    def _opt_index(k):
        return int(k) if k.isdigit() else k

    def _shard_slot(self, bucket, lane, flat_opt):
        sid = (bucket.index, lane.dtype)
        slot = self._shard_slots.get(sid)
        if slot is None:
            for seg in lane.segments:
                if seg.key not in self._store:
                    raise ValueError(
                        "Please initialize key %s first" % seg.key)
            weights = {seg.key: self._store[seg.key]._data.detach()
                       for seg in lane.segments}
            slot = _fusion.ShardSlot(
                lane, None, weights, flat_opt,
                t0=getattr(self._optimizer, "begin_num_update", 0))
            pending = self._pending_shard_state
            if pending and str(sid) in pending:
                slot.set_state(pending.pop(str(sid)))
            self._shard_slots[sid] = slot
        return slot

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows in ``row_ids`` (kvstore.py:377) into a dense
        ``out``: the rows land in a zeroed array of the table's shape. A
        row-sparse ``out`` is ``sparse.py``, which waits for ROADMAP
        A9."""
        assert out is not None and row_ids is not None
        keys, outs = self._normalize(key, out)
        rids = row_ids if isinstance(row_ids, (list, tuple)) else [row_ids]
        if len(rids) == 1 and len(outs) > 1:
            rids = rids * len(outs)
        for k, o, r in zip(keys, outs, rids):
            src = self._store[k]._data
            for dst in (o if isinstance(o, (list, tuple)) else [o]):
                if getattr(dst, "stype", "default") != "default" \
                        or not isinstance(dst, NDArray):
                    raise MXNetError(
                        "row_sparse_pull into a RowSparseNDArray is "
                        "mxnet_tpu/sparse.py, which the PyTorch port has "
                        "not ported yet (ROADMAP item A9); pass a dense out")
                idx = r._data.reshape(-1).to(device=src.device,
                                             dtype=torch.int64)
                rows = torch.zeros_like(dst._data)
                rows[idx] = src[idx].to(device=rows.device, dtype=rows.dtype)
                dst._set_data(rows)

    # -------------------------------------------------------- optimizer --
    def set_optimizer(self, optimizer):
        """Run the optimizer inside the store (kvstore.py:446), the
        update_on_kvstore path: the store is in the process, so it holds
        an Updater where the reference pickles the optimizer to its
        servers."""
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    def set_updater(self, updater):
        self._updater = updater

    def set_gradient_compression(self, compression_params):
        """2-bit gradient compression (kvstore.py:512): each pushed
        worker value is quantized to +-threshold/0 codes with an
        error-feedback residual and reconstructed before aggregation."""
        params = dict(compression_params)
        self._gc = GradientCompression(
            type=params.get("type", "none"),
            threshold=float(params.get("threshold", 0.5)))
        self._residuals.clear()

    @property
    def gradient_compression(self):
        return self._gc

    # ------------------------------------------------------------ misc --
    @property
    def type(self):
        return "local"

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def barrier(self):
        self._barrier_count += 1

    def send_command_to_servers(self, head, body):
        pass

    def save_optimizer_states(self, fname, dump_optimizer=False):
        assert self._updater is not None, \
            "Cannot save states for distributed training"
        payload = self._updater.get_states(dump_optimizer)
        if self._shard_slots:
            # the sharded update's state (flat master weight and
            # optimizer state per bucket lane) rides beside the
            # updater's per-key states
            payload = pickle.dumps(
                {"__fused_shard_v1__": True, "updater": payload,
                 "slots": {str(sid): slot.get_state()
                           for sid, slot in self._shard_slots.items()}})
        with open(fname, "wb") as fout:
            fout.write(payload)

    def load_optimizer_states(self, fname):
        assert self._updater is not None, \
            "Cannot load states for distributed training"
        with open(fname, "rb") as fin:
            raw = fin.read()
        try:
            loaded = pickle.loads(raw)
        except Exception:
            loaded = None
        if isinstance(loaded, dict) and loaded.get("__fused_shard_v1__"):
            self._updater.set_states(loaded["updater"])
            slots = dict(loaded["slots"])
            for sid, slot in self._shard_slots.items():
                snap = slots.pop(str(sid), None)
                if snap is not None:
                    slot.set_state(snap)
            # slots a fresh store has not made yet take their state when
            # the first fused push makes them
            self._pending_shard_state = slots or None
        else:
            self._updater.set_states(raw)


class KVStoreLocal(KVStore):
    """'local': aggregation on the values' device (comm.h CommCPU)."""

    @property
    def type(self):
        return "local"


class KVStoreDevice(KVStore):
    """'device': aggregation on the accelerator (comm.h CommDevice); the
    same execution as 'local' here."""

    @property
    def type(self):
        return "device"


class KVStoreTPUSync(KVStore):
    """'dist_sync': synchronous data parallelism over a torch.distributed
    world (the JAX package's class name and ``type`` are kept).

    Every rank holds the same stored values and applies the same
    all-reduced updates. A push sums the rank's own worker list, then
    all-reduces that sum across the world (the JAX package's
    ``_cross_process_allreduce``, the reference's NumWorkers() merge in
    kvstore_dist_server.h:346); on a world of one it is the local sum.
    The sharded update is possible when the world has more than one
    rank."""

    @staticmethod
    def _world():
        return _fusion._world_of(None)

    def _aggregate(self, k, datas):
        local = _sum_n(datas)
        if self._world()[0] == 1:
            return local
        # the reduction is in place: never into a caller's tensor
        local = local.clone(memory_format=torch.contiguous_format) \
            if local is datas[0] else local.contiguous()
        torch.distributed.all_reduce(local)
        return local

    def supports_shard_update(self):
        return self._world()[0] > 1

    @property
    def type(self):
        return "dist_tpu_sync"

    @property
    def rank(self):
        return self._world()[1]

    @property
    def num_workers(self):
        return self._world()[0]

    @property
    def num_dead_node(self):
        return 0

    def barrier(self):
        if self._world()[0] > 1:
            torch.distributed.barrier()
        super().barrier()


def create(name="local", **kwargs):
    """mx.kvstore.create (kvstore.py:635 / src/kvstore/kvstore.cc:40).
    ``kwargs`` are the store's knobs: ``fusion``, ``shard_update``,
    ``bucket_bytes`` and ``bigarray_bound``."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    name = name.lower()
    if name in ("local", "local_update_cpu", "local_allreduce_cpu"):
        return KVStoreLocal(**kwargs)
    if name in ("device", "local_allreduce_device", "nccl"):
        return KVStoreDevice(**kwargs)
    if name in ("dist_tpu_sync", "dist_sync", "dist_device_sync", "dist"):
        return KVStoreTPUSync(**kwargs)
    if name == "dist_async":
        raise ValueError(
            "dist_async (the parameter server's asynchronous mode) is not "
            "supported: the world's collectives are synchronous. Use "
            "dist_sync. (the JAX package's divergence, SURVEY §2.3)")
    raise ValueError("Unknown KVStore type %s" % name)
