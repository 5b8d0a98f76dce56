"""The port's kvstore stack (``mxnet_tpu_torch.kvstore``,
``gradient_compression``, ``kvstore_server``) against the JAX package's
on the CPU, in one process: the ``local`` and ``device`` stores' push,
pull and pushpull with per-worker lists, ``update_on_kvstore`` through
``set_optimizer`` and ``set_updater``, ``pushpull_fused`` against per-key
push and pull (mixed dtypes across a bucket boundary, the bigarray rule,
the plan cache), the ``dispatch_stats`` contract, the dense
``row_sparse_pull``, the optimizer states' round trip, ``create``'s
aliases and refusals, 2-bit compression (the packed words and the
residuals, and the compressed push) and the server role's refusals.

Inputs are seeded numpy arrays. Tolerances: a sum of worker values,
the 2-bit words and residuals, and the fused path against the per-key
path are bitwise; an optimizer's update against JAX's within rtol 1e-5,
atol 1e-5 (fp32; XLA may contract a rule's multiply-add into one fused
rounding where torch rounds twice, and Adam's division grows that
last-place difference), the bound ``tests/test_torch_optimizer.py``
holds the rules to. The dist store over a
world of ranks is ``tests/test_torch_kvstore_world.py``'s."""

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.parallel import fusion
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHAPES = {3: (4, 5), 5: (7,), 9: (2, 3, 2)}
OPT_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    with mt.cpu():
        yield


def _vals(seed, shapes=SHAPES, workers=1, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return {k: [rng.randn(*s).astype(dtype) for _ in range(workers)]
            for k, s in shapes.items()}


def _nd(mx, arrays):
    return [mx.nd.array(a) for a in arrays]


def _np(x):
    return np.asarray(x.asnumpy(), np.float32)


@pytest.mark.parametrize("name", ["local", "device"])
@pytest.mark.parametrize("workers", [1, 3])
def test_push_pull_pushpull_match_jax(name, workers):
    """init, push of each key's worker list, pull into a list of outs,
    and pushpull: the aggregates are JAX's, bitwise."""
    init = _vals(0)
    grads = _vals(1, workers=workers)
    got = {}
    for key, mx in (("port", mt), ("jax", jmx)):
        kv = mx.kvstore.create(name)
        assert kv.type == name and kv.rank == 0 and kv.num_workers == 1
        kv.init(list(init), [mx.nd.array(v[0]) for v in init.values()])
        kv.push(list(grads), [_nd(mx, v) for v in grads.values()])
        outs = {k: [mx.nd.zeros(SHAPES[k]) for _ in range(2)]
                for k in grads}
        kv.pull(list(outs), list(outs.values()))
        again = {k: mx.nd.zeros(SHAPES[k]) for k in grads}
        kv.pushpull(3, _nd(mx, grads[3]), out=again[3])
        got[key] = ({k: [_np(o) for o in v] for k, v in outs.items()},
                    _np(again[3]))
    for k in grads:
        want = np.sum(grads[k], axis=0)
        for t, j in zip(got["port"][0][k], got["jax"][0][k]):
            np.testing.assert_array_equal(t, j)
            np.testing.assert_array_equal(t, want)
    np.testing.assert_array_equal(got["port"][1], got["jax"][1])


def test_pull_of_an_uninitialized_key_raises():
    kv = mt.kvstore.create("local")
    with pytest.raises(ValueError, match="initialize key 7"):
        kv.pull(7, mt.nd.zeros((2,)))
    kv.set_optimizer(mt.optimizer.SGD())
    with pytest.raises(ValueError, match="initialize key 7"):
        kv.push(7, mt.nd.zeros((2,)))


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_update_on_kvstore_matches_jax(opt):
    """set_optimizer moves the update into the store: three pushes of
    two workers' gradients update the stored weights, and a pull returns
    them, JAX's within OPT_TOL."""
    init = _vals(2)
    hyper = dict(learning_rate=0.1, wd=1e-3, rescale_grad=0.5)
    if opt == "sgd":
        hyper["momentum"] = 0.9
    got = {}
    for key, mx in (("port", mt), ("jax", jmx)):
        kv = mx.kvstore.create("device")
        kv.init(list(init), [mx.nd.array(v[0]) for v in init.values()])
        kv.set_optimizer(mx.optimizer.create(opt, **hyper))
        for step in range(3):
            grads = _vals(10 + step, workers=2)
            kv.push(list(grads), [_nd(mx, v) for v in grads.values()])
        outs = {k: mx.nd.zeros(SHAPES[k]) for k in init}
        kv.pull(list(outs), list(outs.values()))
        got[key] = {k: _np(v) for k, v in outs.items()}
    for k in init:
        np.testing.assert_allclose(got["port"][k], got["jax"][k], **OPT_TOL)
        assert not np.array_equal(got["port"][k], init[k][0])


def test_set_updater_runs_on_push():
    seen = []

    def updater(index, grad, weight):
        seen.append((index, grad.asnumpy().copy()))
        weight[:] = weight - grad

    kv = mt.kvstore.create("local")
    kv.init(4, mt.nd.ones((3,)))
    kv.set_updater(updater)
    kv.push(4, [mt.nd.ones((3,)), mt.nd.ones((3,))])
    out = mt.nd.zeros((3,))
    kv.pull(4, out)
    assert seen[0][0] == 4
    np.testing.assert_array_equal(seen[0][1], [2, 2, 2])
    np.testing.assert_array_equal(out.asnumpy(), [-1, -1, -1])


# keys, shapes and dtypes with a bucket boundary inside each dtype's run
# (128-byte buckets), a bfloat16 lane between float32 ones, and a key
# above the bigarray bound (16 elements here) that travels alone
FUSED = [("0", (5,), "float32"), ("1", (3, 4), "bfloat16"),
         ("2", (20,), "float32"), ("3", (6,), "bfloat16"),
         ("4", (2, 3), "float32"), ("5", (30,), "float32"),
         ("6", (9,), "bfloat16")]


def _fused_values(seed, workers):
    rng = np.random.RandomState(seed)
    return {k: [rng.randn(*s).astype(np.float32) for _ in range(workers)]
            for k, s, _ in FUSED}


def _typed(mx, a, dtype):
    return mx.nd.array(a).astype(dtype)


def _fused_run(mx, fused, workers, updater, bucket_bytes=128):
    """(the outs after pushpull_fused, dispatch_stats) or, with
    fused=False, after per-key push and pull."""
    kwargs = {} if mx is jmx else dict(bigarray_bound=16)
    kv = mx.kvstore.create("device", **kwargs)
    init = _fused_values(3, 1)
    kv.init([k for k, _, _ in FUSED],
            [_typed(mx, init[k][0], d) for k, _, d in FUSED])
    if updater:
        kv.set_optimizer(mx.optimizer.create(
            "sgd", learning_rate=0.1, momentum=0.9, wd=1e-4))
    outs = {k: _typed(mx, np.zeros(s, np.float32), d) for k, s, d in FUSED}
    for step in range(2):
        vals = _fused_values(20 + step, workers)
        values = [[_typed(mx, a, d) for a in vals[k]] for k, _, d in FUSED]
        keys = [k for k, _, _ in FUSED]
        if fused:
            kv.pushpull_fused(keys, values,
                              out=[outs[k] for k in keys],
                              bucket_bytes=bucket_bytes)
        else:
            for k, v in zip(keys, values):
                kv.push(k, v)
                kv.pull(k, outs[k])
    return ({k: (str(v.dtype), _np(v)) for k, v in outs.items()},
            dict(kv.dispatch_stats), kv)


@pytest.mark.parametrize("updater", [False, True])
@pytest.mark.parametrize("workers", [1, 2])
def test_pushpull_fused_is_bitwise_per_key(updater, workers):
    """The fused path (buckets of 128 bytes, a bf16 lane between fp32
    ones, a bigarray alone) gives the per-key push + pull's outs bitwise,
    in each key's dtype, with and without an optimizer in the store."""
    fused, _, _ = _fused_run(mt, True, workers, updater)
    per_key, _, _ = _fused_run(mt, False, workers, updater)
    for k, _, d in FUSED:
        assert fused[k][0] == per_key[k][0] == d
        np.testing.assert_array_equal(fused[k][1], per_key[k][1])


@pytest.mark.parametrize("updater", [False, True])
def test_pushpull_fused_matches_jax(updater):
    """The same fused run in both packages, bitwise without an optimizer
    and within OPT_TOL with one. JAX reads the bigarray bound from its
    environment (1e6), the port from its argument, so the port runs with
    the same bound here."""
    got, stats, _ = _fused_run(mt, True, 2, updater, bucket_bytes=1 << 20)
    kv = mt.kvstore.create("device")
    assert kv.bigarray_bound == fusion.DEFAULT_BIGARRAY_BOUND
    want, jstats, _ = _fused_run(jmx, True, 2, updater,
                                 bucket_bytes=1 << 20)
    for k, _, _ in FUSED:
        assert got[k][0] == want[k][0]
        if updater:
            np.testing.assert_allclose(got[k][1], want[k][1], **OPT_TOL)
        else:
            np.testing.assert_array_equal(got[k][1], want[k][1])
    assert stats["keys"] == jstats["keys"] == 2 * len(FUSED)


def test_dispatch_stats_contract():
    """Per fused call: keys counts every key, buckets every bucket,
    collectives one per bucket lane; per-key push counts one collective
    and one key each; reset_dispatch_stats zeroes them. The plan is made
    once per signature."""
    _, stats, kv = _fused_run(mt, True, 1, False)
    plan = fusion.plan_buckets(
        [(k, s, d) for k, s, d in FUSED], 128, 16)
    lanes = sum(len(b.lanes) for b in plan)
    assert len(plan) > 2 and lanes > len(plan)
    assert stats == {"collectives": 2 * lanes, "keys": 2 * len(FUSED),
                     "buckets": 2 * len(plan), "shard_updates": 0}
    assert len(kv._fusion_plans) == 1
    _, per_key, _ = _fused_run(mt, False, 1, False)
    assert per_key == {"collectives": 2 * len(FUSED),
                       "keys": 2 * len(FUSED), "buckets": 0,
                       "shard_updates": 0}
    kv.reset_dispatch_stats()
    assert set(kv.dispatch_stats.values()) == {0}
    jkv = jmx.kvstore.create("local")
    assert sorted(jkv.dispatch_stats) == sorted(kv.dispatch_stats)
    with pytest.raises(ValueError, match="same worker count"):
        kv.pushpull_fused(["0", "2"], [[mt.nd.zeros((5,))],
                                       [mt.nd.zeros((20,))] * 2])


def test_row_sparse_pull_into_a_dense_out_matches_jax():
    table = np.random.RandomState(4).randn(6, 3).astype(np.float32)
    rows = np.array([4, 1, 4], np.float32)
    got = {}
    for key, mx in (("port", mt), ("jax", jmx)):
        kv = mx.kvstore.create("local")
        kv.init("emb", mx.nd.array(table))
        outs = [mx.nd.ones((6, 3)), mx.nd.ones((6, 3))]
        kv.row_sparse_pull("emb", out=outs, row_ids=mx.nd.array(rows))
        got[key] = [_np(o) for o in outs]
    for t, j in zip(got["port"], got["jax"]):
        np.testing.assert_array_equal(t, j)
    want = np.zeros_like(table)
    want[[1, 4]] = table[[1, 4]]
    np.testing.assert_array_equal(got["port"][0], want)


def test_row_sparse_pull_into_a_row_sparse_out_names_a9():
    class RowSparse(object):
        stype = "row_sparse"

    kv = mt.kvstore.create("local")
    kv.init(0, mt.nd.ones((4, 2)))
    with pytest.raises(mt.MXNetError, match="A9"):
        kv.row_sparse_pull(0, out=RowSparse(), row_ids=mt.nd.array([1]))


def test_optimizer_states_round_trip(tmp_path):
    """save_optimizer_states / load_optimizer_states: a store restored
    from the file (its momentum) continues exactly as the one that saved
    it."""
    def run(fname, resume):
        kv = mt.kvstore.create("device")
        kv.init(0, mt.nd.array(np.arange(4, dtype=np.float32)))
        kv.set_optimizer(mt.optimizer.create("sgd", learning_rate=0.1,
                                             momentum=0.9))
        kv.push(0, mt.nd.ones((4,)))
        if resume:
            kv.save_optimizer_states(fname)
            w = mt.nd.zeros((4,))
            kv.pull(0, w)
            kv = mt.kvstore.create("device")
            kv.init(0, w)
            kv.set_optimizer(mt.optimizer.create("sgd", learning_rate=0.1,
                                                 momentum=0.9))
            kv.load_optimizer_states(fname)
            assert sorted(kv._updater.states) == [0]
        kv.push(0, mt.nd.ones((4,)) * 2)
        out = mt.nd.zeros((4,))
        kv.pull(0, out)
        return out.asnumpy()

    np.testing.assert_array_equal(run(str(tmp_path / "a"), False),
                                  run(str(tmp_path / "b"), True))
    kv = mt.kvstore.create("local")
    with pytest.raises(AssertionError):
        kv.save_optimizer_states(str(tmp_path / "c"))


@pytest.mark.parametrize("name,kind,typ", [
    ("local", "KVStoreLocal", "local"),
    ("local_update_cpu", "KVStoreLocal", "local"),
    ("local_allreduce_cpu", "KVStoreLocal", "local"),
    ("device", "KVStoreDevice", "device"),
    ("local_allreduce_device", "KVStoreDevice", "device"),
    ("nccl", "KVStoreDevice", "device"),
    ("dist_sync", "KVStoreTPUSync", "dist_tpu_sync"),
    ("dist_device_sync", "KVStoreTPUSync", "dist_tpu_sync"),
    ("dist", "KVStoreTPUSync", "dist_tpu_sync"),
    ("DIST_TPU_SYNC", "KVStoreTPUSync", "dist_tpu_sync")])
def test_create_aliases(name, kind, typ):
    kv = mt.kvstore.create(name)
    assert type(kv).__name__ == kind and kv.type == typ
    assert kv.type == jmx.kvstore.create(name).type
    assert kv.fusion is True and kv.shard_update is False
    assert kv.bucket_bytes == 25 << 20 and kv.bigarray_bound == 10 ** 6
    if typ == "dist_tpu_sync":
        # no process group: a world of one, and no sharded update
        assert (kv.rank, kv.num_workers, kv.num_dead_node) == (0, 1, 0)
        assert not kv.supports_shard_update()
        kv.barrier()


def test_create_refusals():
    with pytest.raises(ValueError, match="dist_async"):
        mt.kvstore.create("dist_async")
    with pytest.raises(ValueError, match="Unknown KVStore type"):
        mt.kvstore.create("ps")
    with pytest.raises(TypeError):
        mt.kvstore.create(3)
    kv = mt.kvstore.create("device", fusion=False, shard_update=True,
                           bucket_bytes=64, bigarray_bound=8)
    assert (kv.fusion, kv.shard_update, kv.bucket_bytes,
            kv.bigarray_bound) == (False, True, 64, 8)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 1000])
@pytest.mark.parametrize("threshold", [0.5, 0.1, 1.3])
def test_two_bit_words_and_residuals_are_jaxs(n, threshold):
    import jax.numpy as jnp
    rng = np.random.RandomState(n)
    g = rng.randn(n).astype(np.float32)
    r = (rng.randn(n) * 0.3).astype(np.float32)
    tgc = mt.gradient_compression.GradientCompression("2bit", threshold)
    jgc = jmx.gradient_compression.GradientCompression("2bit", threshold)
    tw, tr = tgc.quantize(torch.from_numpy(g), torch.from_numpy(r))
    jw, jr = jgc.quantize(jnp.asarray(g), jnp.asarray(r))
    assert tw.dtype == torch.int32 and tw.shape == (-(-n // 16),)
    np.testing.assert_array_equal(tw.numpy().view(np.uint32),
                                  np.asarray(jw))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tgc.dequantize(tw, (n,)).numpy(),
                                  np.asarray(jgc.dequantize(jw, (n,))))


def test_compression_surface_and_errors():
    gc = mt.gradient_compression.GradientCompression("2bit", 0.25)
    assert gc.active and gc.get_compression_factor() == 16
    assert gc.compressed_size(33) == 3 == \
        jmx.gradient_compression.GradientCompression(
            "2bit", 0.25).compressed_size(33)
    none = mt.gradient_compression.GradientCompression()
    assert not none.active and none.get_compression_factor() == 1
    assert none.compressed_size(33) == 33
    for kw in (dict(type="1bit"), dict(type="2bit", threshold=0),
               dict(type="2bit", threshold=-1.0)):
        with pytest.raises(ValueError):
            mt.gradient_compression.GradientCompression(**kw)
    # the codes: 11 for +t, 10 for -t, 00 for 0; value i in bits 30-2i..31
    w, _ = gc.quantize(torch.tensor([1.0, -1.0, 0.0, 1.0]), torch.zeros(4))
    assert int(w.numpy().view(np.uint32)[0]) == (3 << 30) | (2 << 28) | \
        (3 << 24)


@pytest.mark.parametrize("fused", [False, True])
def test_compressed_push_matches_jax(fused):
    """Three compressed pushes of two workers' gradients: the aggregates
    and every (key, worker) residual are JAX's, bitwise."""
    init = _vals(5)
    got = {}
    for key, mx in (("port", mt), ("jax", jmx)):
        kv = mx.kvstore.create("local")
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.7})
        assert kv.gradient_compression.threshold == 0.7
        kv.init(list(init), [mx.nd.array(v[0]) for v in init.values()])
        for step in range(3):
            grads = _vals(30 + step, workers=2)
            vals = [_nd(mx, v) for v in grads.values()]
            if fused:
                kv.pushpull_fused(list(grads), vals)
            else:
                kv.push(list(grads), vals)
        outs = {k: mx.nd.zeros(SHAPES[k]) for k in init}
        kv.pull(list(outs), list(outs.values()))
        got[key] = ({k: _np(v) for k, v in outs.items()},
                    {k: np.asarray(r) for k, r in kv._residuals.items()})
    for k in init:
        np.testing.assert_array_equal(got["port"][0][k], got["jax"][0][k])
    assert sorted(got["port"][1]) == sorted(got["jax"][1])
    for k, r in got["port"][1].items():
        np.testing.assert_array_equal(r, got["jax"][1][k])


def test_server_role_refusals(monkeypatch):
    server = mt.kvstore_server.KVStoreServer(mt.kvstore.create("dist_sync"))
    with pytest.raises(RuntimeError, match="no server role"):
        server.run()
    for role in ("server", "scheduler"):
        monkeypatch.setenv("DMLC_ROLE", role)
        with pytest.raises(RuntimeError, match="DMLC_ROLE=%s" % role):
            mt.kvstore_server._init_kvstore_server_module()
    monkeypatch.setenv("DMLC_ROLE", "worker")
    mt.kvstore_server._init_kvstore_server_module()
