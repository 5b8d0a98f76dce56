"""Gluon DataLoader (port of ``mxnet_tpu/gluon/data/dataloader.py``).

Reference: python/mxnet/gluon/data/dataloader.py:77-285 — worker
processes decode/augment and ship batches through POSIX-shm pickled
NDArrays (src/storage/cpu_shared_storage_manager.h:269).

Three tiers, as in the JAX package:

* ``num_workers=0`` — serial, on the calling thread.
* ``num_workers>0, thread_pool=True`` — a thread pool. Each batch is made
  under the context current where the epoch started (the context is
  thread-local; a pool thread would otherwise make it on ``gpu(0)``).
* ``num_workers>0`` (default) — a PROCESS pool with shared-memory batch
  passing. Each worker runs ``dataset[i]`` and a numpy batchify and
  writes the batch into one ``multiprocessing.shared_memory`` segment;
  the parent maps it and makes the NDArrays, the only device copy.
  Workers stay on the host: the dataset is pickled with every NDArray
  in it rebuilt on the CPU, and a worker runs under ``cpu()`` with no
  CUDA device visible, so none of them starts CUDA. With
  ``pin_memory=True`` (accepted and a no-op in the JAX package) the
  parent puts each batch in pinned host memory before its copy to a
  GPU context, so the copy does not block; values do not change.

Workers always start with ``spawn``: the parent may hold a CUDA context,
which is not fork-safe, so the reference's ``MXNET_MP_START_METHOD`` has
no counterpart. The dataset and batchify must be picklable;
``thread_pool=True`` takes unpicklable ones.
"""

import copyreg
import io
import os
import pickle
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ... import ndarray as nd
from ...base import MXNetError, dtype_name, np_dtype
from ...context import cpu, current_context
from .sampler import SequentialSampler, RandomSampler, BatchSampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch NDArray (recursively for tuples)."""
    if isinstance(data[0], nd.NDArray):
        return nd.stack(*data, axis=0)
    if isinstance(data[0], (tuple, list)):
        data = zip(*data)
        return [default_batchify_fn(i) for i in data]
    data = np.asarray(data)
    return nd.array(data, dtype=data.dtype)


def default_mp_batchify_fn(data):
    """Worker-side batchify: numpy only (the parent converts to NDArray
    after the shm hop). Reference counterpart: default_mp_batchify_fn
    building shared-mem NDArrays (gluon/data/dataloader.py:77)."""
    first = data[0]
    if isinstance(first, nd.NDArray):  # dataset already made NDArrays
        return np.stack([d.asnumpy() for d in data])
    if isinstance(first, (tuple, list)):
        return [default_mp_batchify_fn(list(i)) for i in zip(*data)]
    return np.stack([np.asarray(d) for d in data])


# ------------------------------------------------------ shm transport ---
def _dtype_token(dtype):
    """Round-trippable dtype spelling. `.str` turns ml_dtypes bfloat16
    into an opaque '<V2' void dtype; names survive."""
    return dtype.name if dtype.names is None else dtype.str


def _dtype_from_token(token):
    try:
        return np.dtype(token)
    except TypeError:
        return np.dtype(np_dtype(torch.bfloat16))


def _tree_arrays(tree, out):
    """Flatten nested lists/tuples of ndarrays, collecting leaves."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_arrays(t, out) for t in tree)
    arr = np.ascontiguousarray(np.asarray(tree))
    out.append(arr)
    return len(out) - 1  # leaf placeholder: index into the array list


def _tree_fill(tree, leaves):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_fill(t, leaves) for t in tree)
    return leaves[tree]


def _batch_to_shm(batch):
    """Write every array leaf of `batch` into ONE SharedMemory segment.
    Returns (shm_name, structure, specs) — specs are (offset, shape,
    dtype_str) per leaf. The worker closes its mapping but does NOT
    unlink; the consumer unlinks after mapping (see _batch_from_shm)."""
    from multiprocessing import shared_memory
    arrays = []
    structure = _tree_arrays(batch, arrays)
    total = sum(a.nbytes for a in arrays)
    shm = shared_memory.SharedMemory(create=True, size=max(total, 1))
    specs = []
    off = 0
    for a in arrays:
        view = np.ndarray(a.shape, a.dtype, buffer=shm.buf, offset=off)
        view[...] = a
        specs.append((off, a.shape, _dtype_token(a.dtype)))
        off += a.nbytes
    name = shm.name
    shm.close()
    return name, structure, specs


def _batch_from_shm(name, structure, specs, convert):
    """Map the segment, rebuild the batch tree, unlink. `convert` turns
    each leaf into its final form (an NDArray, which copies, in the
    parent) BEFORE the local handle is dropped, so no view outlives the
    segment."""
    from multiprocessing import shared_memory
    shm = shared_memory.SharedMemory(name=name)
    try:
        leaves = [convert(np.ndarray(shape, _dtype_from_token(dt),
                                     buffer=shm.buf, offset=off))
                  for off, shape, dt in specs]
        return _tree_fill(structure, leaves)
    finally:
        try:
            shm.close()
        finally:
            try:
                shm.unlink()
            except FileNotFoundError:
                pass


def _host_ndarray(obj):
    """An NDArray pickled for a worker: rebuilt on the CPU there."""
    return (nd._ndarray_unpickle,
            (obj.asnumpy(), dtype_name(obj.dtype), "cpu"))


def _host_dumps(obj):
    """``pickle.dumps`` with every NDArray reduced to a CPU one."""
    buf = io.BytesIO()
    pickler = pickle.Pickler(buf)
    pickler.dispatch_table = copyreg.dispatch_table.copy()
    pickler.dispatch_table[nd.NDArray] = _host_ndarray
    pickler.dump(obj)
    return buf.getvalue()


def _spawn_worker_entry(payload, key_queue, data_queue):
    """Worker entry: keep the worker on the host BEFORE unpickling
    anything (the dataset's NDArrays are rebuilt there): no CUDA device is
    visible to it (set before its first CUDA call, where CUDA reads it),
    and its default context is the CPU."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    cpu().__enter__()
    try:
        dataset, batchify_fn = pickle.loads(payload)
    except Exception:
        # a worker that cannot even build its dataset must say so, or
        # the parent would block forever on an empty data queue
        data_queue.put((-1, -1, "fatal", traceback.format_exc()))
        data_queue.close()
        data_queue.join_thread()        # flushed before the exit
        os._exit(1)
    _worker_loop(dataset, key_queue, data_queue, batchify_fn)


def _worker_loop(dataset, key_queue, data_queue, batchify_fn):
    """Worker process body — PERSISTENT across epochs (spawn startup is
    seconds; the reference likewise keeps its worker pool alive for the
    DataLoader's lifetime). Batches go out through shm; only
    (generation, index, shm-spec) crosses the queue."""
    while True:
        item = key_queue.get()
        if item is None:
            break
        gen, idx, indices = item
        try:
            batch = batchify_fn([dataset[i] for i in indices])
            payload = _batch_to_shm(batch)
            data_queue.put((gen, idx, "ok", payload))
        except Exception:
            data_queue.put((gen, idx, "error", traceback.format_exc()))
    # leave as the startup-failure path does, once the queue is flushed
    data_queue.close()
    data_queue.join_thread()
    os._exit(0)


def _shutdown_pool(key_queue, data_queue, workers):
    """Finalizer for the persistent pool (module-level: must not retain
    the DataLoader). Sends one sentinel per worker, then reaps."""
    try:
        for _ in workers:
            key_queue.put(None)
    except (OSError, ValueError):
        pass
    # drain so worker feeder threads can flush and exit, and so
    # outstanding shm segments get unlinked
    try:
        while True:
            rgen, idx, status, payload = data_queue.get(timeout=0.2)
            if status == "ok":
                _batch_from_shm(*payload, convert=lambda a: None)
    except Exception:     # noqa: BLE001 — Empty, or a queue torn down
        pass
    for w in workers:
        w.join(timeout=5)
        if w.is_alive():
            w.terminate()


class DataLoader(object):
    """Loads data from a Dataset and returns mini-batches.

    Parameters mirror the reference loader: dataset, batch_size, shuffle,
    sampler, last_batch, batch_sampler, batchify_fn, num_workers,
    pin_memory, prefetch, thread_pool.
    """

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=False):
        self._dataset = dataset
        self._pin_memory = pin_memory
        self._thread_pool = thread_pool
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError(
                    "batch_size must be specified unless batch_sampler is "
                    "specified")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError(
                    "shuffle must not be specified if sampler is specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch if last_batch else "keep")
        elif (batch_size is not None or shuffle or sampler is not None or
              last_batch is not None):
            raise ValueError(
                "batch_size, shuffle, sampler and last_batch must not be "
                "specified if batch_sampler is specified.")
        self._batch_sampler = batch_sampler
        self._user_batchify = batchify_fn
        self._batchify_fn = batchify_fn if batchify_fn is not None \
            else default_batchify_fn
        self._num_workers = max(0, num_workers)
        self._prefetch = max(0, int(prefetch) if prefetch is not None
                             else 2 * self._num_workers)

    def _make_batch(self, indices):
        return self._batchify_fn([self._dataset[i] for i in indices])

    def _make_batch_in(self, ctx, indices):
        with ctx:
            return self._make_batch(indices)

    # ------------------------------------------------------ iteration ---
    def __iter__(self):
        if self._num_workers == 0:
            for batch in self._batch_sampler:
                yield self._make_batch(batch)
            return
        if self._thread_pool:
            yield from self._iter_threads()
        else:
            yield from self._iter_processes()

    def _iter_threads(self):
        ctx = current_context()
        with ThreadPoolExecutor(max_workers=self._num_workers) as pool:
            futures = []
            it = iter(self._batch_sampler)
            try:
                for _ in range(self._num_workers + self._prefetch):
                    futures.append(pool.submit(self._make_batch_in, ctx,
                                               next(it)))
            except StopIteration:
                it = None
            while futures:
                batch = futures.pop(0).result()
                if it is not None:
                    try:
                        futures.append(pool.submit(self._make_batch_in, ctx,
                                                   next(it)))
                    except StopIteration:
                        it = None
                yield batch

    def _ensure_pool(self):
        """Start (once) the persistent worker pool; respawning per epoch
        would pay seconds of spawn startup every __iter__."""
        if getattr(self, "_pool_workers", None):
            return
        import multiprocessing as mp
        import weakref
        ctx = mp.get_context("spawn")
        batchify = self._user_batchify if self._user_batchify is not None \
            else default_mp_batchify_fn
        self._key_queue = ctx.Queue()
        self._data_queue = ctx.Queue()
        payload = _host_dumps((self._dataset, batchify))
        workers = [ctx.Process(
            target=_spawn_worker_entry,
            args=(payload, self._key_queue, self._data_queue),
            daemon=True) for _ in range(self._num_workers)]
        for w in workers:
            w.start()
        self._pool_workers = workers
        self._pool_gen = 0
        # shut the pool down when the loader is garbage collected, via a
        # finalizer that must NOT hold a reference back to self
        weakref.finalize(self, _shutdown_pool, self._key_queue,
                         self._data_queue, workers)

    def _get_result(self, data_queue):
        """data_queue.get with worker-liveness checks: a dead pool must
        raise, not hang the parent forever."""
        import queue as _queue
        while True:
            try:
                return data_queue.get(timeout=5)
            except _queue.Empty:
                dead = [w.pid for w in self._pool_workers
                        if w.exitcode is not None]
                if dead:
                    raise MXNetError(
                        "DataLoader worker process(es) %s died without "
                        "reporting a result (killed? failed to start?); "
                        "aborting iteration" % dead)

    def _converter(self):
        """The parent's leaf conversion: an NDArray on the context
        current at the epoch's start, through pinned host memory when
        ``pin_memory`` and the context is a GPU's."""
        ctx = current_context()
        if not (self._pin_memory and ctx.device_type == "gpu"):
            return lambda arr: nd.array(arr, ctx=ctx)
        device = ctx.torch_device

        def to_nd(arr):
            host = nd.array(arr, ctx=cpu())._data.pin_memory()
            return nd.NDArray(host.to(device, non_blocking=True), ctx)
        return to_nd

    def _iter_processes(self):
        if getattr(self, "_iter_active", False):
            # one persistent pool, shared queues: two interleaved epochs
            # would consume each other's results. Fail loudly (the
            # reference's per-iterator worker sets allow this; here use
            # separate DataLoaders or thread_pool=True instead).
            raise MXNetError(
                "concurrent iteration of a multiprocess DataLoader is "
                "not supported; create separate DataLoader objects or "
                "use thread_pool=True")
        self._iter_active = True
        to_nd = self._converter()
        self._ensure_pool()
        self._pool_gen += 1
        gen = self._pool_gen
        key_queue, data_queue = self._key_queue, self._data_queue

        sent = 0
        received = {}
        next_idx = 0
        it = iter(self._batch_sampler)
        try:
            for _ in range(self._num_workers + self._prefetch):
                try:
                    key_queue.put((gen, sent, next(it)))
                    sent += 1
                except StopIteration:
                    it = None
                    break
            while next_idx < sent:
                while next_idx not in received:
                    rgen, idx, status, payload = self._get_result(
                        data_queue)
                    if status == "fatal":
                        raise MXNetError(
                            "DataLoader worker failed to start:\n%s"
                            % payload)
                    if rgen != gen:   # stale epoch (early break): drop
                        if status == "ok":
                            _batch_from_shm(*payload,
                                            convert=lambda a: None)
                        continue
                    if status == "error":
                        raise MXNetError(
                            "DataLoader worker failed:\n%s" % payload)
                    received[idx] = payload
                payload = received.pop(next_idx)
                next_idx += 1
                if it is not None:
                    try:
                        key_queue.put((gen, sent, next(it)))
                        sent += 1
                    except StopIteration:
                        it = None
                yield _batch_from_shm(*payload, convert=to_nd)
        finally:
            # results of this epoch that were never consumed (early
            # break) stay queued; the NEXT epoch's stale-generation
            # check unlinks them lazily. The pool outlives the epoch.
            self._iter_active = False
            for payload in received.values():
                _batch_from_shm(*payload, convert=lambda a: None)

    def __len__(self):
        return len(self._batch_sampler)
