"""The port's data iterators (``mxnet_tpu_torch.io``) against the JAX
package's, on the same arrays and files made from a seed, with numpy's
global state seeded alike (it drives the shuffles, crops and mirrors in
both): every batch, label, pad and index, and every ``state_dict`` round
trip (the resumed iterator gives the uninterrupted one's batches), is
exact. ``PrefetchingIter``'s fetcher threads make their batches under
the context current where it was built (a thread's default is
``gpu(0)``, which raises here), and ``_retry_read`` retries and reports
as JAX's does, with ``io_retries``/``io_backoff_ms`` in place of the
environment."""

import gzip
import struct

import numpy as np
import pytest

from mxnet_tpu import io as jio
from mxnet_tpu import recordio as jrec

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import _native as tnative
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch.observability import chaos as tchaos
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

RS = np.random.RandomState(2)
X = RS.rand(23, 3, 2).astype(np.float32)
Y = np.arange(23, dtype=np.float32)
Z = RS.randint(0, 9, (23, 4)).astype(np.int32)


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


def _drain(it, epochs=2, reset=True):
    out = []
    for e in range(epochs):
        if e and reset:
            it.reset()
        for b in it:
            out.append(([d.asnumpy() for d in b.data],
                        [l.asnumpy() for l in (b.label or [])], b.pad,
                        b.index))
    return out


def _same(a, b):
    assert len(a) == len(b)
    for (da, la, pa, ia), (db, lb, pb, ib) in zip(a, b):
        assert pa == pb and (ia is None) == (ib is None)
        for u, v in zip(da + la, db + lb):
            assert u.dtype == v.dtype and u.shape == v.shape
            np.testing.assert_array_equal(u, v)


def _both(make, **drain):
    out = []
    for mod in (tio, jio):
        np.random.seed(4)
        out.append(_drain(make(mod), **drain))
    _same(*out)
    return out[0]


@pytest.mark.parametrize("kw", [
    dict(last_batch_handle="pad"), dict(last_batch_handle="discard"),
    dict(last_batch_handle="roll_over"),
    dict(last_batch_handle="pad", shuffle=True),
    dict(last_batch_handle="roll_over", shuffle=True)],
    ids=["pad", "discard", "roll_over", "pad-shuffle", "roll_over-shuffle"])
def test_ndarray_iter_matches_jax(kw):
    got = _both(lambda m: m.NDArrayIter(X, Y, batch_size=5, **kw),
                epochs=3)
    assert got[0][0][0].shape == (5, 3, 2)
    _both(lambda m: m.NDArrayIter({"a": X, "b": Z}, {"y": Y}, batch_size=7,
                                  **kw))
    _both(lambda m: m.NDArrayIter([X, Z], None, batch_size=4, **kw))


def test_descs_and_batches_match_jax():
    t = tio.NDArrayIter({"a": X, "b": Z}, Y, batch_size=6)
    j = jio.NDArrayIter({"a": X, "b": Z}, Y, batch_size=6)
    assert [(d.name, d.shape, np.dtype(d.dtype)) for d in t.provide_data] \
        == [(d.name, d.shape, np.dtype(d.dtype)) for d in j.provide_data]
    assert [tuple(d) for d in t.provide_label] == \
        [tuple(d) for d in j.provide_label]
    d = tio.DataDesc("x", (2, 3), layout="NHWC")
    assert repr(d) == repr(jio.DataDesc("x", (2, 3), layout="NHWC"))
    assert tio.DataDesc.get_batch_axis("TNC") == 1
    assert str(t.next()) == "DataBatch: data shapes: [(6, 3, 2), (6, 4)] " \
        "label shapes: [(6,)]"
    assert issubclass(tio.MXDataIter, tio.DataIter)
    with pytest.raises(NotImplementedError):
        tio.DataIter().state_dict()


def _take(it, n):
    return [([d.asnumpy() for d in b.data], [l.asnumpy() for l in b.label],
             b.pad, b.index) for b in (it.next() for _ in range(n))]


@pytest.mark.parametrize("handle", ["pad", "roll_over"])
def test_ndarray_iter_state_dict_resumes_exactly(handle):
    def make(m):
        return m.NDArrayIter(X, Y, batch_size=5, shuffle=True,
                             last_batch_handle=handle)
    np.random.seed(9)
    ref = _drain(make(tio), epochs=2)
    np.random.seed(9)
    it = make(tio)
    head = _drain(it, epochs=1)
    it.reset()
    head.extend(_take(it, 2))             # mid-epoch (roll_over: its tail)
    state = it.state_dict()
    rest = {}
    for mod in (tio, jio):
        np.random.seed(123)               # the restore replays no draw
        fresh = make(mod)
        fresh.load_state_dict(state)
        rest[mod] = _drain(fresh, epochs=1, reset=False)
    _same(head + rest[tio], ref)
    _same(rest[tio], rest[jio])


def test_resize_and_prefetching_iters_match_jax():
    _both(lambda m: m.ResizeIter(m.NDArrayIter(X, Y, batch_size=4), 9),
          epochs=2)
    got = _both(lambda m: m.PrefetchingIter(
        [m.NDArrayIter(X, Y, batch_size=4, shuffle=True),
         m.NDArrayIter(Z, Y, batch_size=4, data_name="z",
                       label_name="w")],
        rename_data=[{"data": "x0"}, {"z": "x1"}]), epochs=2)
    assert len(got) == 2 * 6
    it = tio.PrefetchingIter(tio.NDArrayIter(X, Y, batch_size=4))
    assert [d.name for d in it.provide_data] == ["data"]
    b = it.next()
    assert b.data[0].context == mt.cpu()   # made on the fetcher thread
    assert it.state_dict()["inner"][0]["cursor"] == 0
    ri = tio.ResizeIter(tio.NDArrayIter(X, Y, batch_size=4), 3)
    ri.next()
    st = ri.state_dict()
    ri2 = tio.ResizeIter(tio.NDArrayIter(X, Y, batch_size=4), 3)
    ri2.load_state_dict(st)
    np.testing.assert_array_equal(ri2.next().data[0].asnumpy(),
                                  ri.next().data[0].asnumpy())


class _Failing(tio.DataIter):
    def __init__(self):
        super().__init__(2)
        self.provide_data = [tio.DataDesc("data", (2,))]
        self.provide_label = []
        self.calls = 0

    def next(self):
        self.calls += 1
        if self.calls == 2:
            raise ValueError("fetch failed")
        if self.calls > 3:
            raise StopIteration
        return tio.DataBatch([mt.nd.zeros((2,))], [], pad=0)

    def reset(self):
        self.calls = 0


def test_prefetching_iter_errors_end_of_epoch_and_recovery():
    it = tio.PrefetchingIter(_Failing())
    assert it.iter_next()
    with pytest.raises(ValueError, match="fetch failed"):
        it.iter_next()
    assert not it.iter_next() and not it.iter_next()
    it.reset()
    assert it.iter_next()
    with pytest.raises(NotImplementedError, match="_Failing"):
        it.state_dict()


def _write_csv(path, arr):
    np.savetxt(path, arr.reshape(arr.shape[0], -1), delimiter=",")


def test_csv_libsvm_and_mnist_iters_match_jax(tmp_path):
    data, label = str(tmp_path / "d.csv"), str(tmp_path / "l.csv")
    _write_csv(data, X)
    _write_csv(label, Y[:, None])
    for rb in (True, False):
        _both(lambda m: m.CSVIter(data, (3, 2), label_csv=label,
                                  batch_size=5, round_batch=rb))
    svm = str(tmp_path / "d.svm")
    with open(svm, "w") as f:
        for r in range(11):
            f.write("%d %s\n" % (r % 2, " ".join(
                "%d:%.5g" % (c, RS.randn()) for c in range(r % 5, 8, 2))))
    _both(lambda m: m.LibSVMIter(svm, (8,), batch_size=3))
    lib = tnative.libsvm_lib()
    assert lib is not None
    tnative._libs["libsvm_scan"] = None           # the Python parser
    try:
        py = _drain(tio.LibSVMIter(svm, (8,), batch_size=3))
    finally:
        tnative._libs["libsvm_scan"] = lib
    _same(py, _drain(jio.LibSVMIter(svm, (8,), batch_size=3)))
    imgs = RS.randint(0, 256, (13, 5, 4)).astype(np.uint8)
    labels = RS.randint(0, 10, 13).astype(np.uint8)
    ipath, lpath = str(tmp_path / "i-idx3-ubyte.gz"), \
        str(tmp_path / "l-idx1-ubyte")
    with gzip.open(ipath, "wb") as f:
        f.write(struct.pack(">HBB", 0, 8, 3) + struct.pack(">III", 13, 5, 4)
                + imgs.tobytes())
    with open(lpath, "wb") as f:
        f.write(struct.pack(">HBB", 0, 8, 1) + struct.pack(">I", 13)
                + labels.tobytes())
    for flat in (False, True):
        _both(lambda m: m.MNISTIter(ipath, lpath, batch_size=4, flat=flat))


@pytest.fixture(scope="module")
def npy_rec(tmp_path_factory):
    """.npy image records (odd sizes, gray and colour, 2-wide labels)
    written by the JAX package."""
    import io as _io
    d = tmp_path_factory.mktemp("rec")
    rec, idx = str(d / "a.rec"), str(d / "a.idx")
    w = jrec.MXIndexedRecordIO(idx, rec, "w")
    rs = np.random.RandomState(6)
    for i in range(11):
        shape = (20 + i % 3, 26) if i == 4 else (20 + i % 3, 26, 3)
        buf = _io.BytesIO()
        np.save(buf, rs.randint(0, 256, shape).astype(np.uint8))
        label = [float(i), float(i % 3)]
        w.write_idx(i, jrec.pack(jrec.IRHeader(0, label, i, 0),
                                 buf.getvalue()))
    w.close()
    return rec, idx


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, rand_crop=True, rand_mirror=True),
    dict(resize=24, mean_r=120.0, mean_g=110.0, mean_b=100.0, std_r=50.0,
         std_g=60.0, std_b=70.0, rand_mirror=True),
    dict(data_shape=(3, 30, 30), label_width=2)],
    ids=["crop-mirror", "resize-normalize", "upscale-label2"])
def test_image_record_iter_matches_jax(npy_rec, kw):
    rec, idx = npy_rec
    kw = dict(kw)
    shape = kw.pop("data_shape", (3, 16, 18))
    got = _both(lambda m: m.ImageRecordIter(
        rec, shape, 4, path_imgidx=idx, **kw), epochs=2)
    assert got[0][0][0].shape == (4,) + shape and got[-1][2] == 1


def test_image_record_iter_native_and_python_paths_and_state(npy_rec):
    rec, idx = npy_rec
    np.random.seed(3)
    native = tio.ImageRecordIter(rec, (3, 16, 16), 4, path_imgidx=idx,
                                 shuffle=True)
    lib = tnative.recordio_lib()
    assert lib is not None
    tnative._libs["recordio_scan"] = None           # the Python reads
    try:
        np.random.seed(3)
        python = tio.ImageRecordIter(rec, (3, 16, 16), 4, path_imgidx=idx,
                                     shuffle=True)
    finally:
        tnative._libs["recordio_scan"] = lib
    assert native.native_read and not python.native_read
    assert len(native._records) == len(python._records) == 11
    for (hn, pn), (hp, pp) in zip(native._records, python._records):
        assert pn == pp and hn.id == hp.id
        np.testing.assert_array_equal(hn.label, hp.label)
    a = native.next()
    state = native.state_dict()
    rest = _drain(native, epochs=1, reset=False)
    resumed = tio.ImageRecordIter(rec, (3, 16, 16), 4, path_imgidx=idx)
    resumed.load_state_dict(state)
    _same(_drain(resumed, epochs=1, reset=False), rest)
    np.testing.assert_array_equal(a.data[0].asnumpy(),
                                  python.next().data[0].asnumpy())
    assert a.data[0].context == mt.cpu()


def test_retry_read_and_chaos_on_the_read_path(npy_rec, tmp_path):
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("blip")
        return "ok"
    assert tio._retry_read(flaky, "read", retries=3, backoff_ms=1) == "ok"
    calls.clear()
    with pytest.raises(IOError, match=r"read failed after 1 attempt\(s\) "
                       r"\(path=p, batch=4\): OSError: blip"):
        tio._retry_read(flaky, "read", path="p", index=4, retries=0)
    rec, idx = npy_rec
    data = str(tmp_path / "d.csv")
    _write_csv(data, X)
    tchaos.install("io.read:error:at=0")
    try:
        np.random.seed(1)
        it = tio.ImageRecordIter(rec, (3, 16, 16), 4, io_backoff_ms=1)
        assert len(it._records) == 11        # the record read retried
        assert not it.native_read            # chaos reads record by record
        it.next()
        tio.CSVIter(data, (3, 2), batch_size=5, io_backoff_ms=1)
    finally:
        tchaos.reset()
    tchaos.install("io.read:error:count=0")
    try:
        with pytest.raises(IOError, match="csv read failed after 3"):
            tio.CSVIter(data, (3, 2), io_retries=2, io_backoff_ms=1)
    finally:
        tchaos.reset()
