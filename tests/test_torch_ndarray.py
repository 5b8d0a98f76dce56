"""The port's NDArray (``mxnet_tpu_torch.ndarray``) against the JAX
package's, on the same numpy inputs made from a seed: creation and
dtypes, contexts (the default ``gpu(0)`` raises without CUDA), fluent
methods, indexing, value semantics under writes and views, the save
format in both directions (bitwise, bfloat16 included) and DLPack."""

import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.base import dtype_name
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

RS = np.random.RandomState(0)
X = RS.rand(3, 4).astype(np.float32)


def _dt(x):
    if isinstance(x, tnd.NDArray):
        return dtype_name(x.dtype)
    return np.dtype(x.dtype).name


def _same(jx, tx, rtol=1e-6, atol=1e-6):
    assert _dt(jx) == _dt(tx), (_dt(jx), _dt(tx))
    assert tuple(jx.shape) == tuple(tx.shape)
    np.testing.assert_allclose(tx.asnumpy().astype(np.float64),
                               jx.asnumpy().astype(np.float64),
                               rtol=rtol, atol=atol)


@pytest.fixture
def cpu():
    with mt.cpu() as ctx:
        yield ctx


DTYPE_CASES = [
    ([[1.5, 2.0], [3.0, 4.0]], None),
    ([[1, 2], [3, 4]], None),
    (np.arange(6, dtype=np.float64).reshape(2, 3), None),
    (np.array([2**40, -3], dtype=np.int64), None),
    (np.array([True, False]), None),
    (np.arange(4, dtype=np.uint8), None),
    (X, "float16"),
    (X, "bfloat16"),
    (X, "int32"),
    (X, np.float64),
]


@pytest.mark.parametrize("source, dtype", DTYPE_CASES)
def test_array_dtypes_follow_jax(cpu, source, dtype):
    _same(jnd.array(source, dtype=dtype), tnd.array(source, dtype=dtype))


@pytest.mark.parametrize("source, dtype", DTYPE_CASES)
def test_dtype_is_numpys_as_in_jax(cpu, source, dtype):
    """``dtype`` is a numpy dtype, as the reference's: it equals numpy's
    type and JAX's, ``np.dtype`` takes it, and ``asnumpy`` gives that
    type (bfloat16 through ``ml_dtypes``)."""
    j, t = jnd.array(source, dtype=dtype), tnd.array(source, dtype=dtype)
    want = np.dtype(j.dtype)
    assert t.dtype == want and t.dtype == j.dtype
    assert np.dtype(t.dtype) == want and t.dtype.name == want.name
    assert t.dtype == getattr(np, want.name, want)
    assert t.asnumpy().dtype == j.asnumpy().dtype
    assert t.astype(t.dtype).dtype == j.astype(j.dtype).dtype
    assert tnd.zeros((2,), dtype=t.dtype).dtype == \
        jnd.zeros((2,), dtype=j.dtype).dtype


def test_bfloat16_without_ml_dtypes(cpu, monkeypatch):
    """Where ``ml_dtypes`` is missing a bf16 array's dtype is an object
    that compares equal to "bfloat16" and to itself, and ``asnumpy``
    gives float32; the arithmetic is unchanged."""
    import sys
    from mxnet_tpu_torch import base
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    monkeypatch.setattr(base, "_NP_DTYPES", {})
    x = tnd.array(X, dtype="bfloat16")
    assert x.dtype is base.BFLOAT16
    assert x.dtype == "bfloat16" and x.dtype == base.BFLOAT16
    assert x.dtype != np.float32 and x.dtype != "float32"
    assert str(x.dtype) == "bfloat16" and dtype_name(x.dtype) == "bfloat16"
    assert hash(x.dtype) == hash("bfloat16")
    host = x.asnumpy()
    assert host.dtype == np.float32
    want = jnd.array(X, dtype="bfloat16").asnumpy().astype(np.float32)
    np.testing.assert_array_equal(host, want)
    y = (x * 2).astype(x.dtype)
    assert y.dtype == "bfloat16"
    np.testing.assert_array_equal(y.asnumpy(), want * 2)
    back = pickle.loads(pickle.dumps(x))
    assert back.dtype == "bfloat16"
    assert tnd.zeros((2,), dtype=x.dtype)._data.dtype == torch.bfloat16


def test_infer_type_gives_numpy_dtypes_as_jax_does():
    def infer(pkg):
        net = pkg.sym.FullyConnected(pkg.sym.var("data"), num_hidden=3,
                                     name="fc")
        return net.infer_type(data="float32")
    port, ref = infer(mt), infer(mx)
    assert port == ref
    known = [d for part in port for d in part if d is not None]
    assert known and all(isinstance(d, np.dtype) for d in known)


@pytest.mark.parametrize("make", [
    lambda nd: nd.zeros((2, 3)),
    lambda nd: nd.ones((4,), dtype="int32"),
    lambda nd: nd.full((2, 2), 7.5, dtype="float16"),
    lambda nd: nd.empty((1, 2)),
    lambda nd: nd.arange(0, 10, 2),
    lambda nd: nd.arange(5, repeat=2, dtype="int32"),
    lambda nd: nd.eye(3, 4, k=-1),
    lambda nd: nd.linspace(-1, 1, 5),
    lambda nd: nd.linspace(0, 1, 4, endpoint=False),
])
def test_creation_functions(cpu, make):
    _same(make(jnd), make(tnd))


def test_default_context_is_the_gpu_and_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mt.current_context() == mt.gpu(0)
    with pytest.raises(mt.MXNetError, match="cpu"):
        tnd.zeros((2,))
    with pytest.raises(mt.MXNetError):
        tnd.array([1.0, 2.0])
    with pytest.raises(mt.MXNetError):
        mt.gpu(1).torch_device
    with pytest.raises(RuntimeError):
        mt.gpu_memory_info()
    assert mt.num_gpus() == 0


def test_context_scopes_and_identity():
    with mt.cpu():
        a = tnd.ones((2,))
        assert a.context == mt.cpu(0) and a.context.device_type == "cpu"
        assert mt.current_context() == mt.cpu()
        with mt.Context("cpu", 1):
            assert mt.current_context().device_id == 1
        assert mt.current_context() == mt.cpu()
    b = tnd.ones((2,), ctx=mt.cpu())
    assert str(b.context) == "cpu(0)" and repr(mt.gpu(2)) == "gpu(2)"
    assert hash(mt.cpu()) == hash(mt.Context(mt.cpu()))
    assert mt.Context("gpu", 3).device_typeid == 2
    assert mt.resolve_device(mt.cpu()) == torch.device("cpu")
    assert b.as_in_context(mt.cpu()) is b


def test_fluent_methods_and_operators(cpu):
    x = X - 0.5
    y = RS.rand(3, 4).astype(np.float32) + 0.5
    for f in (lambda nd, a, b: a.sin(), lambda nd, a, b: a.sum(axis=1),
              lambda nd, a, b: a.reshape((4, 3)),
              lambda nd, a, b: a.reshape(-1, 2), lambda nd, a, b: a.T,
              lambda nd, a, b: a.argmax(axis=0), lambda nd, a, b: a.max(),
              lambda nd, a, b: a.clip(-0.2, 0.2),
              lambda nd, a, b: a.transpose((1, 0)).flatten(),
              lambda nd, a, b: a.expand_dims(0).squeeze(0),
              lambda nd, a, b: a.astype("int32"),
              lambda nd, a, b: a.norm(axis=1),
              lambda nd, a, b: a.slice_axis(1, 1, 3),
              lambda nd, a, b: a % b, lambda nd, a, b: 2.0 % b,
              lambda nd, a, b: a ** 2, lambda nd, a, b: 2 ** a,
              lambda nd, a, b: 1.0 - a / b, lambda nd, a, b: -abs(a),
              lambda nd, a, b: a > b, lambda nd, a, b: 0.1 >= a,
              lambda nd, a, b: a != b, lambda nd, a, b: nd.maximum(a, 0.1),
              lambda nd, a, b: nd.logical_and(a, b),
              lambda nd, a, b: nd.concatenate([a, b], axis=1),
              lambda nd, a, b: a.split(2, axis=1)[1],
              lambda nd, a, b: nd.split_v2(a, (1, 3), axis=1)[2],
              lambda nd, a, b: a.slice_assign_scalar(9.0, (0, 0), (1, 2)),
              lambda nd, a, b: nd.moveaxis(a, 0, 1)):
        _same(f(jnd, jnd.array(x), jnd.array(y)),
              f(tnd, tnd.array(x), tnd.array(y)))
    a = tnd.array(X)
    assert a.size == 12 and a.ndim == 2 and len(a) == 3
    assert float(tnd.array([2.5])) == 2.5 and int(tnd.array([3.0])) == 3
    assert tnd.array([7.0]).asscalar() == 7.0 and a.stype == "default"
    with pytest.raises(ValueError):
        bool(a)


@pytest.mark.parametrize("key", [
    1, (1, 2), slice(1, 3), (slice(None), 2), (Ellipsis, slice(0, 3, 2)),
    "index_array", "mask", (slice(0, 2), "index_array"),
])
def test_getitem(cpu, key):
    def resolve(nd):
        if key == "index_array":
            return nd.array([2, 0], dtype="int32")
        if key == "mask":
            return nd.array([True, False, True])
        if isinstance(key, tuple):
            return tuple(nd.array([2, 0], dtype="int32")
                         if k == "index_array" else k for k in key)
        return key
    _same(jnd.array(X)[resolve(jnd)], tnd.array(X)[resolve(tnd)])


@pytest.mark.parametrize("key, value", [
    (1, 5.0), ((0, 2), -1.0), (slice(None), 2.0),
    (slice(1, 3), "array"), ((slice(None), 1), "column"),
])
def test_setitem(cpu, key, value):
    outs = []
    for nd in (jnd, tnd):
        a = nd.array(X)
        v = value
        if value == "array":
            v = nd.array(np.ones((2, 4), np.float32) * 3)
        elif value == "column":
            v = nd.array(np.arange(3, dtype=np.float32))
        a[key] = v
        outs.append(a)
    _same(*outs)


def test_value_semantics_under_writes_and_views(cpu):
    a = tnd.array(X)
    views = {"reshape": a.reshape((4, 3)), "slice": a[1:3], "T": a.T,
             "identity": tnd.identity(a), "detach": a.detach()}
    kept = {k: v.asnumpy().copy() for k, v in views.items()}
    a[0] = 100.0                    # __setitem__
    a += 1.0                        # an in-place operator
    for k, v in views.items():
        np.testing.assert_array_equal(v.asnumpy(), kept[k], err_msg=k)
    np.testing.assert_allclose(a.asnumpy()[0], 101.0)

    b = tnd.array(X)
    r = b.reshape((12,))
    r[3] = -7.0
    r *= 2.0
    s = b[0:2]
    s[:] = 0.0
    np.testing.assert_array_equal(b.asnumpy(), X)

    # a raw-pointer writer takes a buffer of its own first (rtc launches
    # and to_dlpack_for_write): a view, or storage another tensor holds,
    # is copied; a buffer nobody shares is written where it lies
    c = tnd.array(X)
    v = c.reshape((2, 6))
    v._own_buffer().add_(1.0)
    np.testing.assert_array_equal(c.asnumpy(), X)
    np.testing.assert_array_equal(v.asnumpy(), X.reshape(2, 6) + 1)
    own = tnd.array(X)
    ptr = own._data.data_ptr()
    assert own._own_buffer().data_ptr() == ptr
    d = tnd.array(X)
    alias = tnd.NDArray(d._data)
    tnd.to_dlpack_for_write(d).mul_(0.0)
    np.testing.assert_array_equal(alias.asnumpy(), X)
    assert float(d.sum().asscalar()) == 0.0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_save_load_across_packages_bitwise(tmp_path, writer):
    arrays = {"f32": X, "i32": np.arange(6, dtype=np.int32).reshape(2, 3),
              "i64": np.array([2**40, -5], dtype=np.int64),
              "u8": np.arange(5, dtype=np.uint8),
              "scalar": np.array(3.25, dtype=np.float32)}
    path = str(tmp_path / ("from_%s.nd" % writer))
    with mt.cpu():
        src, dst = (jnd, tnd) if writer == "jax" else (tnd, jnd)
        data = {k: src.array(v, dtype=v.dtype) for k, v in arrays.items()}
        data["bf16"] = src.array(X).astype("bfloat16")
        src.save(path, data)
        back = dst.load(path)
        assert set(back) == set(data)
        for k in data:
            assert _dt(back[k]) == _dt(data[k]), k
            np.testing.assert_array_equal(back[k].asnumpy(),
                                          data[k].asnumpy(), err_msg=k)
        lst = [src.ones((2,)), src.array(X).astype("bfloat16")]
        src.save(path, lst)
        got = dst.load(path)
        assert isinstance(got, list) and _dt(got[1]) == "bfloat16"
        np.testing.assert_array_equal(got[1].asnumpy(), lst[1].asnumpy())
        with open(path, "rb") as f:
            buf = f.read()
        assert len(tnd.load_frombuffer(buf)) == 2
        with pytest.raises(mt.MXNetError):
            tnd.load_frombuffer(b"not an ndarray file")


def test_load_without_ctx_raises_the_device_error(tmp_path, monkeypatch):
    """C11: without ``ctx`` on a host with no CUDA device, ``nd.load`` and
    ``load_parameters`` raise the default context's own message; only a
    file that is not in the format is "invalid NDArray file"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "w.params")
    with mt.cpu():
        net = mt.gluon.nn.Dense(3, in_units=2)
        net.initialize()
        net.save_parameters(path)
        assert set(tnd.load(path)) == set(net._collect_params_with_prefix())
    for load in (tnd.load,
                 mt.gluon.nn.Dense(3, in_units=2).load_parameters):
        with pytest.raises(mt.MXNetError, match="no CUDA device .the "
                           "default context is gpu.0.") as err:
            load(path)
        assert "invalid NDArray file" not in str(err.value)
    junk = str(tmp_path / "junk.params")
    with open(junk, "wb") as f:
        f.write(b"MXTPU001\xff\xff")
    with pytest.raises(mt.MXNetError, match="invalid NDArray file"):
        tnd.load(junk)


def test_dlpack_and_torch_interchange(cpu):
    a = tnd.array(X)
    t = tnd.to_dlpack_for_read(a)
    assert isinstance(t, torch.Tensor)
    np.testing.assert_array_equal(torch.from_dlpack(t).numpy(), X)
    b = tnd.from_dlpack(np.arange(4, dtype=np.float32))
    assert b.context == mt.cpu() and b.shape == (4,)
    c = tnd.from_dlpack(jnd.array(X).asjax())
    np.testing.assert_array_equal(c.asnumpy(), X)
    with pytest.raises(mt.MXNetError):
        tnd.from_dlpack(object())
    d = tnd.imperative_invoke("_copy", [a], {}, out=tnd.zeros((3, 4)))
    np.testing.assert_array_equal(d.asnumpy(), X)


def test_what_waits_for_later_items_raises_naming_them(cpu):
    with pytest.raises(mt.MXNetError, match="A9"):
        tnd.zeros((2,), stype="row_sparse")
    with pytest.raises(mt.MXNetError, match="A9"):
        tnd.array(X).tostype("csr")
    with pytest.raises(mt.MXNetError, match="A9"):
        tnd._npi_uniform(low=0, high=1, size=(2,))
    with pytest.raises(mt.MXNetError, match="A9"):
        tnd.MultiBoxPrior(tnd.array(X))
    with pytest.raises(mt.MXNetError, match="A9"):
        tnd.contrib.fft(tnd.array(X))
    # nd.random and the control-flow loops are ported (A9's second item)
    assert tnd.random.uniform(0, 1, shape=(2,)).shape == (2,)
    assert callable(tnd.contrib.foreach)
    with pytest.raises(mt.MXNetError, match="A9"):
        tnd.linalg.gemm2(tnd.array(X), tnd.array(X))
    assert tnd.contrib.boolean_mask is tnd._contrib_boolean_mask
    assert tnd.op.dot is tnd.dot


def test_shuffle_is_a_seeded_permutation(cpu):
    data = np.arange(20, dtype=np.float32).reshape(10, 2)
    mt.random.seed(3)
    first = tnd.random.shuffle(tnd.array(data)).asnumpy()
    mt.random.seed(3)
    again = mt.random.shuffle(tnd.array(data)).asnumpy()
    np.testing.assert_array_equal(first, again)
    assert sorted(map(tuple, first)) == sorted(map(tuple, data))
    assert not np.array_equal(first, data)


def test_storage_tracking_engine_and_pickle(cpu):
    mt.storage.reset_stats()
    mt.storage.start_tracking()
    try:
        keep = [tnd.zeros((4, 4)) for _ in range(3)]
        stats = mt.storage.summary()["cpu(0)"]
        assert stats["live"] >= 3 and stats["live_bytes"] >= 3 * 64
    finally:
        mt.storage.stop_tracking()
    assert mt.storage.device_memory_stats() == {} or torch.cuda.is_available()
    with mt.engine.bulk(4):
        tnd.waitall()
    keep[0].wait_to_read()
    back = pickle.loads(pickle.dumps(tnd.array(X).astype("bfloat16")))
    assert _dt(back) == "bfloat16"
    np.testing.assert_array_equal(back.asnumpy(),
                                  tnd.array(X).astype("bfloat16").asnumpy())
    assert mx.nd.array(X).shape == back.shape
