"""Data iterators (port of ``mxnet_tpu/io.py``).

Reference: python/mxnet/io/io.py:180-790 (DataIter/DataBatch/DataDesc,
NDArrayIter, ResizeIter, PrefetchingIter) and src/io/ (CSVIter,
ImageRecordIter, MNISTIter registered C++ iterators surfaced as MXDataIter).

Iterators assemble host-side numpy batches and convert them to NDArrays
at the boundary, one host-to-device copy a batch, on the context current
where the batch is made (``gpu(0)`` unless the caller says ``with
cpu():``); ``PrefetchingIter``'s fetcher threads make theirs under the
context current where the iterator was built. Batching is static-shape
(pad + discard/roll-over policies), the analogue of the reference's
fixed-batch DataBatchLoader (src/io/iter_batchloader.h). Prefetching uses
a background thread like dmlc::ThreadedIter (src/io/iter_prefetcher.h).

Host-side draws stay where the reference takes them, numpy's global
state (``NDArrayIter``'s shuffle, ``ImageRecordIter``'s shuffle, crop and
mirror), so the same ``np.random.seed`` gives the same batches in both
packages. ``io_retries`` and ``io_backoff_ms`` replace the reference's
``MXNET_IO_RETRIES`` and ``MXNET_IO_BACKOFF_MS``, with their defaults.
The reference's ``io.*`` telemetry spans and counters are not ported
(ROADMAP A10).
"""

import gzip
import struct
import queue
import threading
import time
from collections import namedtuple

import numpy as np

from . import ndarray as nd
from .context import current_context
from .ndarray import NDArray
from . import recordio
from .recordio import RecordCorrupt  # noqa: F401 (re-export)
from .observability import chaos as _chaos


DEFAULT_IO_RETRIES = 3
DEFAULT_IO_BACKOFF_MS = 50.0
_IO_BACKOFF_CAP_S = 1.0


def _retry_read(fn, what, path=None, index=None,
                retries=DEFAULT_IO_RETRIES, backoff_ms=DEFAULT_IO_BACKOFF_MS):
    """Run one read, retrying transient failures (OSError — which
    includes injected ChaosError) with capped exponential backoff:
    ``retries`` attempts after the first (0 disables retrying but keeps
    the enriched error), ``backoff_ms`` initial delay doubling up to 1 s.
    After exhaustion the error is re-raised naming the operation, path,
    and batch index — a dying pipeline must say WHERE it died. ``fn``
    must be idempotent."""
    retries = max(int(retries), 0)
    delay = float(backoff_ms) / 1e3
    for attempt in range(retries + 1):
        try:
            return fn()
        except OSError as exc:
            if attempt >= retries:
                raise IOError(
                    "%s failed after %d attempt(s) (path=%s, "
                    "batch=%s): %s: %s"
                    % (what, retries + 1, path, index,
                       type(exc).__name__, exc)) from exc
            time.sleep(min(delay, _IO_BACKOFF_CAP_S))
            delay *= 2


__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "CSVIter", "MNISTIter", "ImageRecordIter",
           "LibSVMIter", "MXDataIter", "RecordCorrupt"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Name+shape+dtype+layout of one input (io.py:70)."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype,
                                          self.layout)

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")

    @staticmethod
    def get_list(shapes, types):
        if types is not None:
            type_dict = dict(types)
            return [DataDesc(x[0], x[1], type_dict[x[0]]) for x in shapes]
        return [DataDesc(x[0], x[1]) for x in shapes]


class DataBatch(object):
    """One mini-batch (io.py:139)."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None:
            assert isinstance(data, (list, tuple)), "Data must be list of NDArrays"
        if label is not None:
            assert isinstance(label, (list, tuple)), "Label must be list of NDArrays"
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        data_shapes = [d.shape for d in self.data]
        if self.label:
            label_shapes = [l.shape for l in self.label]
        else:
            label_shapes = None
        return "{}: data shapes: {} label shapes: {}".format(
            self.__class__.__name__, data_shapes, label_shapes)


class DataIter(object):
    """Base iterator (io.py:180)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        pass

    def getdata(self):
        pass

    def getlabel(self):
        pass

    def getindex(self):
        return None

    def getpad(self):
        pass

    # ------------------------------------------------------- cursors --
    # Exact-resume contract (docs/ROBUSTNESS.md "Elastic recovery"): a
    # restored iterator must yield the SAME remaining batch sequence
    # the saved one would have — zero skipped, zero replayed samples.
    # state_dict() is a cheap JSON-able position (cursor + epoch order),
    # never buffered data; elastic shard manifests persist it.

    def state_dict(self):
        """Resumable cursor for this iterator. Subclasses that own a
        position implement it; the base class refuses loudly so a
        checkpoint can never silently record a non-resumable source."""
        raise NotImplementedError(
            "%s does not support state_dict()/load_state_dict() — "
            "elastic/exact resume needs a cursor-capable iterator"
            % type(self).__name__)

    def load_state_dict(self, state):
        raise NotImplementedError(
            "%s does not support state_dict()/load_state_dict()"
            % type(self).__name__)


def _init_data(data, allow_empty, default_name):
    """io.py:493 — normalize to list of (name, numpy) pairs."""
    assert (data is not None) or allow_empty
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {default_name + "_%d" % i: d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of them "
                        "or dict with them as values")
    out = {}
    for k, v in data.items():
        if isinstance(v, NDArray):
            out[k] = v.asnumpy()
        else:
            out[k] = np.asarray(v)
    return list(sorted(out.items()))


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays with shuffle + pad/discard/roll_over
    last-batch handling (io.py:560)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True, default_name=label_name)
        self.idx = np.arange(self.data[0][1].shape[0])
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.batch_size = batch_size
        self.cursor = -self.batch_size
        self.num_data = self.idx.shape[0]
        self._cache_data = None
        self._cache_label = None
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype) for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype) for k, v in self.label]

    def hard_reset(self):
        if self.shuffle:
            self._shuffle_data()
        self.cursor = -self.batch_size
        self._cache_data = None
        self._cache_label = None

    def reset(self):
        if self.shuffle:
            self._shuffle_data()
        # roll_over carries the cached tail into the next epoch (io.py:640)
        if self.last_batch_handle == "roll_over" and self._cache_data is not None:
            self.cursor = -len(self._cache_data[0]) - self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        if self.last_batch_handle == "discard":
            return self.cursor <= self.num_data - self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if not self.iter_next():
            raise StopIteration
        data = self.getdata()
        label = self.getlabel()
        if self.cursor < 0:  # cached tail consumed
            self._cache_data = None
            self._cache_label = None
        if data[0].shape[0] != self.batch_size:
            if self.last_batch_handle == "roll_over":
                # cache the tail for the next epoch (reference io.py
                # next())
                self._cache_data = [d.asnumpy() for d in data]
                self._cache_label = [l.asnumpy() for l in label]
                raise StopIteration
            # 'pad': wrap around with samples from the epoch start
            data = self._pad_batch(data, self.data)
            label = self._pad_batch(label, self.label)
        return DataBatch(data=data, label=label, pad=self.getpad(),
                         index=None)

    def _pad_batch(self, arrays, source):
        out = []
        for x, (_, v) in zip(arrays, source):
            pad = self.batch_size - x.shape[0]
            head = x.asnumpy()
            filler = v[self.idx[:pad]]
            out.append(nd.array(np.concatenate([head, filler])))
        return out

    def _getdata(self, data_source, cache):
        if self.cursor < 0:
            # roll_over start-of-epoch: cached tail + head of this epoch
            taken = self.cursor + self.batch_size
            out = []
            for c, (_, v) in zip(cache, data_source):
                out.append(nd.array(np.concatenate([c, v[self.idx[:taken]]])))
            return out
        end = min(self.cursor + self.batch_size, self.num_data)
        s = slice(self.cursor, end)
        return [nd.array(v[self.idx[s]]) for _, v in data_source]

    def getdata(self):
        return self._getdata(self.data, self._cache_data)

    def getlabel(self):
        return self._getdata(self.label, self._cache_label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0

    def _shuffle_data(self):
        np.random.shuffle(self.idx)

    def state_dict(self):
        """Exact mid-epoch position: the cursor plus this epoch's
        shuffle order (idx IS the epoch's sample permutation, so the
        restore replays neither the shuffle nor any sample), plus the
        roll_over tail cache when one is held. Arrays stay numpy —
        persistence layers JSON-ify at write time (elastic
        ``jsonable_cursor``)."""
        state = {"cursor": int(self.cursor), "idx": self.idx.copy()}
        if self._cache_data is not None:
            state["cache_data"] = [np.asarray(c)
                                   for c in self._cache_data]
            state["cache_label"] = [np.asarray(c)
                                    for c in self._cache_label]
        return state

    def load_state_dict(self, state):
        self.cursor = int(state["cursor"])
        self.idx = np.asarray(state["idx"], dtype=self.idx.dtype)
        if "cache_data" in state:
            self._cache_data = [
                np.asarray(c, dtype=v.dtype)
                for c, (_, v) in zip(state["cache_data"], self.data)]
            self._cache_label = [
                np.asarray(c, dtype=v.dtype)
                for c, (_, v) in zip(state["cache_label"], self.label)]
        else:
            self._cache_data = None
            self._cache_label = None


class ResizeIter(DataIter):
    """Resize epoch length of an inner iterator (io.py:351)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size
        if hasattr(data_iter, "default_bucket_key"):
            self.default_bucket_key = data_iter.default_bucket_key

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad

    def state_dict(self):
        return {"cur": int(self.cur),
                "inner": self.data_iter.state_dict()}

    def load_state_dict(self, state):
        self.cur = int(state["cur"])
        self.data_iter.load_state_dict(state["inner"])
        self.current_batch = None


class PrefetchingIter(DataIter):
    """Background-thread prefetcher over one or more iterators (io.py:410)
    — the Python analogue of dmlc::ThreadedIter in iter_prefetcher.h."""

    class _Fetcher(threading.Thread):
        """One background fetcher per inner iterator: each order placed
        on the depth-1 `orders` queue produces one batch (or None at
        end-of-epoch) on `results` — queue backpressure replaces the
        reference's event-pair handshake."""

        _STOP = object()

        def __init__(self, it, ctx):
            super().__init__(daemon=True)
            self.it = it
            # the context is thread-local: batches are made under the
            # one current where the PrefetchingIter was built
            self.ctx = ctx
            self.orders = queue.Queue(1)
            self.results = queue.Queue(1)
            self.pending = False
            self.start()

        def run(self):
            with self.ctx:
                self._serve()

        def _serve(self):
            while True:
                order = self.orders.get()
                if order is self._STOP:
                    return
                try:
                    self.results.put(self.it.next())
                except StopIteration:
                    self.results.put(None)
                except Exception as exc:        # surfaced at take()
                    self.results.put(exc)

        def request(self):
            self.orders.put("fetch")
            self.pending = True

        def take(self):
            out = self.results.get()
            self.pending = False
            if isinstance(out, Exception):
                raise out
            return out

        def stop(self):
            if self.pending:
                self.results.get()
            self.orders.put(self._STOP)

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        self.iters = iters if isinstance(iters, list) else [iters]
        assert self.iters
        self.n_iter = len(self.iters)
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0][1][0]
        self.current_batch = None
        self._drained = False
        ctx = current_context()
        self._fetchers = [self._Fetcher(it, ctx) for it in self.iters]
        # quiescent-point cursor: captured whenever every fetcher is
        # idle (inner iterators advanced exactly as far as the caller
        # consumed), i.e. BEFORE each prefetch order goes out — the
        # position an exact resume must restart from
        self._inner_cursor = self._snapshot_inner()
        for f in self._fetchers:
            f.request()

    def __del__(self):
        for f in getattr(self, "_fetchers", ()):
            f.stop()

    def _renamed_descs(self, which, renames):
        descs = []
        for i, it in enumerate(self.iters):
            for x in getattr(it, which):
                if isinstance(x, DataDesc):
                    # only full descs participate in renaming (tuple
                    # descs pass through untouched — reference parity)
                    name = x.name if renames is None \
                        else renames[i][x.name]
                    descs.append(DataDesc(name, x.shape, x.dtype))
                else:
                    descs.append(DataDesc(*x))
        return descs

    @property
    def provide_data(self):
        return self._renamed_descs("provide_data", self.rename_data)

    @property
    def provide_label(self):
        return self._renamed_descs("provide_label", self.rename_label)

    def reset(self):
        # drain any in-flight fetch before touching the inner iterators
        for f in self._fetchers:
            if f.pending:
                try:
                    f.take()
                except Exception:       # noqa: BLE001 — already seen
                    pass                # by the caller via iter_next
        for it in self.iters:
            it.reset()
        self._drained = False
        self._inner_cursor = self._snapshot_inner()
        for f in self._fetchers:
            f.request()

    def iter_next(self):
        if self._drained:
            # end-of-epoch (or a failed fetch) with no orders
            # outstanding: repeated calls stay False until reset()
            return False
        try:
            batches = [f.take() for f in self._fetchers]
        except Exception:
            self._drained = True        # reset() recovers the others
            raise
        ended = [b is None for b in batches]
        if any(ended):
            assert all(ended), \
                "Number of entry mismatches between iterators"
            self._drained = True
            return False
        assert len({b.pad for b in batches}) == 1, \
            "Different pad size between iterators"
        self.current_batch = DataBatch(
            [d for b in batches for d in b.data],
            [l for b in batches for l in b.label],
            batches[0].pad, batches[0].index,
            provide_data=self.provide_data,
            provide_label=self.provide_label)
        # fetchers are idle here: the inner cursors are exactly one
        # consumed-batch past the previous snapshot
        self._inner_cursor = self._snapshot_inner()
        for f in self._fetchers:
            f.request()
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad

    def _snapshot_inner(self):
        """Inner cursors at a quiescent point (no fetch in flight).
        Inners without cursor support snapshot as None — state_dict
        names them if a resume is ever requested, instead of failing
        every ordinary run up front."""
        out = []
        for it in self.iters:
            try:
                out.append(it.state_dict())
            except NotImplementedError:
                out.append(None)
        return out

    def state_dict(self):
        """Resume position = the last consumed batch. The in-flight
        prefetch does NOT advance it: snapshots are taken only while
        the fetchers are idle, so the saved cursor never skips the
        batch currently being prefetched."""
        missing = [type(it).__name__
                   for it, st in zip(self.iters, self._inner_cursor)
                   if st is None]
        if missing:
            raise NotImplementedError(
                "PrefetchingIter: inner iterator(s) %s do not support "
                "state_dict() — exact resume is impossible through "
                "them" % missing)
        return {"inner": list(self._inner_cursor)}

    def load_state_dict(self, state):
        # drain any in-flight fetch, rewind the inners, refill
        for f in self._fetchers:
            if f.pending:
                try:
                    f.take()
                except Exception:        # noqa: BLE001 — stale epoch
                    pass
        for it, st in zip(self.iters, state["inner"]):
            it.load_state_dict(st)
        self._drained = False
        self._inner_cursor = self._snapshot_inner()
        for f in self._fetchers:
            f.request()


class CSVIter(NDArrayIter):
    """CSV reader (src/io/iter_csv.cc registered as CSVIter). Loads the
    file host-side then batches like NDArrayIter (static shapes)."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True,
                 io_retries=DEFAULT_IO_RETRIES,
                 io_backoff_ms=DEFAULT_IO_BACKOFF_MS, **kwargs):
        def load(path):
            if _chaos.enabled():
                _chaos.fire("io.read", path=path)
            return np.loadtxt(path, delimiter=",", dtype=np.float32,
                              ndmin=2)
        retry = dict(retries=io_retries, backoff_ms=io_backoff_ms)
        data = _retry_read(lambda: load(data_csv), "csv read",
                           path=data_csv, **retry)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = _retry_read(lambda: load(label_csv), "csv read",
                                path=label_csv, **retry)
            label = label.reshape((-1,) + tuple(label_shape))
            if label_shape == (1,):
                label = label.reshape(-1)
        super().__init__(data, label, batch_size=batch_size,
                         last_batch_handle="pad" if round_batch else "discard",
                         data_name=kwargs.get("data_name", "data"),
                         label_name=kwargs.get("label_name", "label"))


class LibSVMIter(NDArrayIter):
    """LibSVM sparse-format reader (src/io/iter_libsvm.cc). Parses into a
    dense array (the sparse types are ROADMAP A9); label supports
    multi-target files."""

    def __init__(self, data_libsvm, data_shape, label_libsvm=None,
                 batch_size=1, **kwargs):
        data, labels = self._parse(data_libsvm, int(np.prod(data_shape)))
        if label_libsvm is not None:
            _, labels2 = self._parse_labels_only(label_libsvm)
            labels = labels2
        super().__init__(data, labels, batch_size=batch_size,
                         last_batch_handle="discard",
                         label_name=kwargs.get("label_name", "softmax_label"))

    @staticmethod
    def _parse(path, dim):
        # native C++ parser first (src/io/libsvm_scan.cc — the
        # reference's iter_libsvm.cc role); Python loop as fallback
        from . import _native
        parsed = _native.libsvm_parse(path, dim)
        if parsed is not None:
            return parsed
        rows, labels = [], []
        with open(path) as f:
            for line in f:
                parts = line.strip().split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                row = np.zeros(dim, dtype=np.float32)
                for t in parts[1:]:
                    k, v = t.split(":")
                    row[int(k)] = float(v)
                rows.append(row)
        return np.stack(rows), np.asarray(labels, dtype=np.float32)

    @staticmethod
    def _parse_labels_only(path):
        labels = []
        with open(path) as f:
            for line in f:
                parts = line.strip().split()
                if parts:
                    labels.append([float(x) for x in parts])
        return None, np.asarray(labels, dtype=np.float32).squeeze()


class MNISTIter(NDArrayIter):
    """MNIST idx-format reader (src/io/iter_mnist.cc). Reads the
    idx3-ubyte/idx1-ubyte (optionally .gz) files."""

    def __init__(self, image, label, batch_size=128, shuffle=True, flat=False,
                 silent=False, seed=0, io_retries=DEFAULT_IO_RETRIES,
                 io_backoff_ms=DEFAULT_IO_BACKOFF_MS, **kwargs):
        retry = dict(retries=io_retries, backoff_ms=io_backoff_ms)
        img = _retry_read(lambda: self._read_idx(image), "idx read",
                          path=image, **retry)
        lbl = _retry_read(lambda: self._read_idx(label), "idx read",
                          path=label, **retry)
        img = img.astype(np.float32) / 255.0
        if flat:
            img = img.reshape(img.shape[0], -1)
        else:
            img = img.reshape(img.shape[0], 1, img.shape[1], img.shape[2])
        super().__init__(img, lbl.astype(np.float32), batch_size=batch_size,
                         shuffle=shuffle, last_batch_handle="discard")

    @staticmethod
    def _read_idx(path):
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rb") as f:
            zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
            dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
            return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


class ImageRecordIter(DataIter):
    """Threaded image-record pipeline (src/io/iter_image_recordio_2.cc).

    Reads RecordIO image records (the whole file at construction: one
    native scan and threaded read, ``MXRecordIO.read_all``, where the
    library builds, else record by record in Python, as the reference,
    which is also the path while chaos rules are installed;
    ``native_read`` says which ran), decodes + augments (resize, crop,
    mirror, mean subtraction) on the host in float32 numpy, one record
    after another on the calling thread (``preprocess_threads`` is
    accepted, as in the reference, and not used: the crop and mirror draw
    from numpy's global state in record order), and emits fixed-shape
    NCHW float32 batches, copied to the current context's device once a
    batch. Payloads are .npy or, through PIL, JPEG/PNG."""

    def __init__(self, path_imgrec, data_shape, batch_size,
                 path_imgidx=None, shuffle=False, mean_r=0.0, mean_g=0.0,
                 mean_b=0.0, std_r=1.0, std_g=1.0, std_b=1.0,
                 rand_crop=False, rand_mirror=False, resize=-1,
                 label_width=1, preprocess_threads=4, round_batch=True,
                 data_name="data", label_name="softmax_label",
                 io_retries=DEFAULT_IO_RETRIES,
                 io_backoff_ms=DEFAULT_IO_BACKOFF_MS, **kwargs):
        super().__init__(batch_size)
        self._retry = dict(retries=io_retries, backoff_ms=io_backoff_ms)
        self.path_imgrec = path_imgrec
        self.record = recordio.MXIndexedRecordIO(path_imgidx, path_imgrec, "r") \
            if path_imgidx else recordio.MXRecordIO(path_imgrec, "r")
        self.data_shape = tuple(data_shape)
        self.shuffle = shuffle
        self.mean = np.array([mean_r, mean_g, mean_b],
                             dtype=np.float32).reshape(3, 1, 1)
        self.std = np.array([std_r, std_g, std_b],
                            dtype=np.float32).reshape(3, 1, 1)
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        self.resize = resize
        self.label_width = label_width
        self.data_name = data_name
        self.label_name = label_name
        self._records = self._load_all()
        self._order = np.arange(len(self._records))
        self.cursor = 0
        self.reset()

    def _load_all(self):
        """Every record, by ``record.read_all`` (native) unless chaos
        rules are installed or the library is unavailable, else by the
        reference's loop; ``native_read`` says which path ran."""
        self.native_read = False
        if not _chaos.enabled():
            # the chaos hooks fire per record on the Python path below
            payloads = _retry_read(self.record.read_all, "record read",
                                   path=self.path_imgrec, **self._retry)
            if payloads is not None:
                self.native_read = True
                return [recordio.unpack(p) for p in payloads]
        out = []
        while True:
            def fetch():
                if _chaos.enabled():
                    _chaos.fire("io.read", path=self.path_imgrec,
                                record=len(out))
                return self.record.read()
            # a record read that hiccups (NFS blip, injected fault)
            # retries with backoff instead of killing the epoch
            rec = _retry_read(fetch, "record read",
                              path=self.path_imgrec, index=len(out),
                              **self._retry)
            if rec is None:
                break
            header, payload = recordio.unpack(rec)
            out.append((header, payload))
        return out

    @property
    def provide_data(self):
        return [DataDesc(self.data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shp = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [DataDesc(self.label_name, shp)]

    def reset(self):
        if self.shuffle:
            np.random.shuffle(self._order)
        self.cursor = 0

    def state_dict(self):
        """Mid-epoch record position: cursor + the epoch's (possibly
        shuffled) record order."""
        return {"cursor": int(self.cursor), "order": self._order.copy()}

    def load_state_dict(self, state):
        self.cursor = int(state["cursor"])
        self._order = np.asarray(state["order"],
                                 dtype=self._order.dtype)

    def _decode_one(self, header, payload):
        img = recordio._imdecode(payload)
        img = np.asarray(img, dtype=np.float32)
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        c, h, w = self.data_shape
        if self.resize > 0:
            img = _resize_hwc(img, self.resize)
        # crop to target h,w (center or random)
        ih, iw = img.shape[:2]
        if ih < h or iw < w:
            img = _resize_hwc(img, max(h, w))
            ih, iw = img.shape[:2]
        if self.rand_crop:
            y = np.random.randint(0, ih - h + 1)
            x = np.random.randint(0, iw - w + 1)
        else:
            y, x = (ih - h) // 2, (iw - w) // 2
        img = img[y:y + h, x:x + w]
        if self.rand_mirror and np.random.rand() < 0.5:
            img = img[:, ::-1]
        chw = img.transpose(2, 0, 1)[:c]
        chw = (chw - self.mean[:c]) / self.std[:c]
        label = header.label if np.ndim(header.label) else \
            np.float32(header.label)
        return chw, label

    def next(self):
        n = len(self._records)
        if self.cursor >= n:
            raise StopIteration
        idxs = [self._order[(self.cursor + i) % n]
                for i in range(self.batch_size)]
        pad = max(0, self.cursor + self.batch_size - n)
        batch_index = self.cursor // self.batch_size
        self.cursor += self.batch_size

        def assemble():
            # idempotent by construction (cursor advanced above): a
            # retried batch decodes the same records again
            if _chaos.enabled():
                _chaos.fire("io.read", path=self.path_imgrec,
                            batch=batch_index)
            datas, labels = [], []
            for i in idxs:
                header, payload = self._records[i]
                d, l = self._decode_one(header, payload)
                datas.append(d)
                labels.append(l)
            return datas, labels

        datas, labels = _retry_read(
            assemble, "record batch decode", path=self.path_imgrec,
            index=batch_index, **self._retry)
        data = nd.array(np.stack(datas))
        label = nd.array(np.asarray(labels, dtype=np.float32))
        return DataBatch(data=[data], label=[label], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)


def _resize_hwc(img, short):
    """Bilinear resize shortest side to `short` (host-side numpy)."""
    h, w = img.shape[:2]
    if h < w:
        nh, nw = short, int(w * short / h)
    else:
        nh, nw = int(h * short / w), short
    ys = np.clip((np.arange(nh) + 0.5) * h / nh - 0.5, 0, h - 1)
    xs = np.clip((np.arange(nw) + 0.5) * w / nw - 0.5, 0, w - 1)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    out = (img[y0][:, x0] * (1 - wy) * (1 - wx) +
           img[y1][:, x0] * wy * (1 - wx) +
           img[y0][:, x1] * (1 - wy) * wx +
           img[y1][:, x1] * wy * wx)
    return out.astype(np.float32)


class MXDataIter(DataIter):
    """Compatibility shim name for C++-registered iterators (io.py:790).
    Here the native iterators are the Python classes above."""
    pass
