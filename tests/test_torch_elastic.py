"""The port's elastic membership protocol (``mxnet_tpu_torch.parallel.
elastic``) held against the JAX package's on the CPU, as
tests/test_elastic.py holds JAX's: every sideband record round-trips and
each package reads the other's files; death detection (staleness, the
start-up grace, post-mortem and quarantine evidence, generation scope,
``prune_stale``); the coordinator's shrink with a fake clock and a
captured exit, its capture read back by both packages, and ``stop``
disarming it; the iterator cursors (``NDArrayIter`` shuffled,
``ImageRecordIter``, ``ResizeIter``, ``PrefetchingIter``) and the RNG
snapshot; ``accumulation_factor``; and ``make_accum_train_step``:
bitwise the port's ``make_train_step`` at ``accum`` 1, deterministic,
its loss the micro-batch mean, its inputs untouched, and against JAX's
step at ``accum`` 1, 2 and 4 on the example's toy model from the same
weights.

Tolerances: records, cursors, captures and the port-to-port comparisons
exact. Against JAX's step, fp32: parameters and momentum rtol 1e-5,
atol 1e-6, the loss rtol 1e-6 (dense fp32 arithmetic in another order).
bf16: the loss rtol 1e-4; each gradient (the new momentum less 0.9 of
the old) within 6% relative L2 of JAX's, whose own bf16 gradient is
1.8-2.7% from its fp32 one here; each parameter within lr times the two
momenta's bf16 difference plus one bf16 unit of its value (both round
``p - lr * m`` once)."""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu import io as jio
from mxnet_tpu.models import checkpoint as jck
from mxnet_tpu.models import transformer as jtf
from mxnet_tpu.parallel import elastic as jel

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch.models import checkpoint as ck
from mxnet_tpu_torch.models import convert
from mxnet_tpu_torch.models import transformer as ttf
from mxnet_tpu_torch.observability import chaos
from mxnet_tpu_torch.parallel import elastic
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = dict(vocab_size=41, d_model=16, n_heads=2, n_layers=1, d_ff=32,
           max_len=32)
LR = 0.1
TOL32 = dict(rtol=1e-5, atol=1e-6)
# a bf16 step's gradient against JAX's, relative L2 per tensor: JAX's own
# bf16 gradient is 1.8-2.7% from its fp32 one on these steps
BF16_GRAD_REL = 6e-2


def tiny_state(seed=0, dtype=torch.float32):
    cfg = ttf.TransformerConfig(dtype=dtype, **CFG)
    params = ttf.init_params(cfg, seed=seed, device="cpu")
    rng = np.random.RandomState(seed + 100)
    mom = {n: torch.from_numpy(rng.standard_normal(tuple(p.shape))
                               .astype(np.float32))
           for n, p in params.named_parameters()}
    return cfg, params, mom


@pytest.fixture(autouse=True)
def _clean():
    chaos.reset()
    elastic.install_coordinator(None)
    elastic._env_beat[0] = 0.0
    with mt.cpu():
        yield
    chaos.reset()
    elastic.install_coordinator(None)


# ---------------------------------------------------------- rendezvous --

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_records_round_trip_across_packages(tmp_path, writer):
    """Generation, heartbeat, shrink and quarantine records written by
    one package read back the same in both."""
    w, r = (elastic, jel) if writer == "port" else (jel, elastic)
    d = str(tmp_path)
    rec = w.write_generation(d, 3, 2, base_world=4, since_wall=123.0)
    w.write_heartbeat(d, 1, 3, step=5, wall=77.0)
    shrink = w.write_shrink_record(d, 4, survivors=[0, 2], dead=[1],
                                   step=7, base_world=3, wall=88.0,
                                   quarantined=[1])
    w.write_quarantine_record(d, 1, 3, {"evidence": "crc", "host": "h1"})
    for mod in (elastic, jel):
        got = mod.read_generation(d)
        assert got == rec and got["ranks"] == [0, 1]
        assert got["base_world"] == 4 and got["since_wall"] == 123.0
        assert mod.read_heartbeats(d, 3) == {
            1: {"rank": 1, "generation": 3, "step": 5, "wall": 77.0}}
        assert mod.read_heartbeats(d, 2) == {}
        assert mod.read_shrink_record(d, 4) == shrink
        assert shrink["survivors"] == [0, 2] and shrink["world"] == 2
        assert mod.read_quarantine_records(d, 3) == [
            {"evidence": "crc", "host": "h1", "rank": 1, "generation": 3}]
        assert mod.quarantined_ranks(d, 3) == {1}
        assert os.path.basename(mod.heartbeat_path(d, 1, 3)) == \
            "hb.g3.rank1.json"


def test_death_detection_matches_jax(tmp_path):
    """Staleness, a missing beat inside and past the grace window, a
    post-mortem and a quarantine record: the same verdicts as JAX's."""
    d = str(tmp_path)
    now = time.time()
    elastic.write_generation(d, 0, 4)
    gen_wall = elastic.read_generation(d)["wall"]
    elastic.write_heartbeat(d, 0, 0, step=5, wall=now)
    elastic.write_heartbeat(d, 1, 0, step=5, wall=now - 10.0)
    cases = [dict(now=now, stale_s=3.0),
             dict(now=gen_wall + 1.0, stale_s=5.0),
             dict(now=gen_wall + 6.0, stale_s=5.0),
             dict(now=now, stale_s=20.0, grace_s=1e6)]
    for kw in cases:
        assert elastic.dead_ranks(d, 0, 4, 0, **kw) == \
            jel.dead_ranks(d, 0, 4, 0, **kw)
    assert elastic.dead_ranks(d, 0, 4, 0, now=now, stale_s=3.0) == {1}
    assert elastic.dead_ranks(d, 0, 4, 0, now=gen_wall + 6.0,
                              stale_s=5.0) == {1, 2, 3}
    assert elastic.dead_ranks(d, 0, 4, 0, now=now, stale_s=20.0,
                              grace_s=1e6) == set()
    with open(os.path.join(d, "postmortem.rank2.txt"), "w") as f:
        f.write("hung in pushpull_fused\n")
    elastic.write_quarantine_record(d, 3, 0, {"evidence": "x"})
    kw = dict(now=now, stale_s=20.0, grace_s=1e6)
    assert elastic.dead_ranks(d, 0, 4, 0, **kw) == {2, 3} == \
        jel.dead_ranks(d, 0, 4, 0, **kw)
    # a fresh beat resurrects a stale rank
    elastic.write_heartbeat(d, 1, 0, step=6, wall=now)
    assert 1 not in elastic.dead_ranks(d, 0, 4, 0, now=now, stale_s=3.0)


def test_prune_stale_drops_previous_generations(tmp_path):
    d = str(tmp_path)
    old = time.time() - 60
    elastic.write_heartbeat(d, 0, 0, wall=old)
    jel.write_heartbeat(d, 1, 0, wall=old)
    elastic.write_shrink_record(d, 1, [0], [1], step=3, wall=old)
    for name in ("wd.rank0.json", "postmortem.rank1.txt"):
        with open(os.path.join(d, name), "w") as f:
            f.write("{}")
        os.utime(os.path.join(d, name), (old, old))
    elastic.write_generation(d, 2, 1)
    elastic.write_heartbeat(d, 0, 2)
    assert elastic.prune_stale(d, 2) == 5
    left = sorted(os.listdir(d))
    assert left == ["gen.json", "hb.g2.rank0.json"]


def test_install_emergency_prunes_stale_sideband(tmp_path, monkeypatch):
    d = str(tmp_path / "sb")
    monkeypatch.setenv("MXNET_ELASTIC_DIR", d)
    monkeypatch.setenv("MXNET_ELASTIC_GENERATION", "3")
    elastic.write_heartbeat(d, 0, 1, wall=time.time() - 60)
    elastic.write_generation(d, 3, 1)
    cfg, params, _ = tiny_state()
    try:
        ck.install_emergency_checkpoint(
            str(tmp_path / "ck"),
            lambda: {"cfg": cfg, "params": params, "step": 0},
            on_sigterm=False, on_sigint=False, atexit_pass=False)
        assert not any(n.startswith("hb.g1") for n in os.listdir(d))
    finally:
        ck.uninstall_emergency_checkpoint()


def test_step_boundary_heartbeats_without_coordinator(tmp_path,
                                                      monkeypatch):
    d = str(tmp_path)
    monkeypatch.setenv("MXNET_ELASTIC_DIR", d)
    monkeypatch.setenv("MXNET_TPU_PROC_ID", "2")
    monkeypatch.setenv("MXNET_ELASTIC_GENERATION", "4")
    assert elastic.enabled() and elastic.rank_env() == 2
    elastic.step_boundary(step=11)
    assert jel.read_heartbeats(d, 4)[2]["step"] == 11
    monkeypatch.delenv("MXNET_ELASTIC_DIR")
    assert not elastic.enabled()


# --------------------------------------------------------- coordinator --

def test_coordinator_shrinks_on_dead_peer(tmp_path):
    """A stale peer under a fake clock: one capture, readable by both
    packages bitwise, one shrink record, one exit 44, however often
    checked."""
    d, ckd = str(tmp_path / "sb"), str(tmp_path / "ck")
    cfg, params, mom = tiny_state()
    exits = []
    elastic.write_generation(d, 0, 2)
    elastic.write_heartbeat(d, 1, 0, wall=time.time())
    coord = elastic.ElasticCoordinator(
        ckd, lambda: {"cfg": cfg, "params": params, "momentum": mom,
                      "step": 9, "cursor": {"cursor": 16}},
        d=d, rank=0, world=2, generation=0, monitor=False, interval=1.0,
        miss=2, exit=exits.append)
    assert coord.check() == set()
    future = time.time() + 10.0
    assert coord.check(now=future) == {1}
    assert exits == [elastic.SHRINK_EXIT_CODE]
    rec = jel.read_shrink_record(d, 1)
    assert rec["survivors"] == [0] and rec["step"] == 9
    assert ck.list_shard_generations(ckd) == [(1, 9, 1)] == \
        jck.list_shard_generations(ckd)
    _, p2, m2, step, extras = ck.load_shard_checkpoint(ckd, device="cpu")
    assert step == 9 and extras["cursor"] == {"cursor": 16}
    for n, t in params.named_parameters():
        assert torch.equal(dict(p2.named_parameters())[n], t)
        assert torch.equal(m2[n], mom[n])
    _, jp, jm, jstep, _ = jck.load_shard_checkpoint(ckd)
    assert jstep == 9
    assert np.array_equal(np.asarray(jm["embed"]), mom["embed"].numpy())
    assert np.array_equal(np.asarray(jp["layers"][0]["wq"]),
                          params.layers[0].wq.numpy())
    assert coord.capture["step"] == 9 and coord.capture["bytes"] > 0
    coord.check(now=future + 5)
    assert exits == [elastic.SHRINK_EXIT_CODE]


def test_coordinator_stop_disarms_shrink(tmp_path):
    d, ckd = str(tmp_path / "sb"), str(tmp_path / "ck")
    cfg, params, _ = tiny_state()
    exits = []
    elastic.write_generation(d, 0, 2)
    coord = elastic.ElasticCoordinator(
        ckd, lambda: {"cfg": cfg, "params": params, "step": 1},
        d=d, rank=0, world=2, generation=0, monitor=False,
        exit=exits.append)
    assert coord.stop() is True          # this call disarmed it
    coord.check(now=time.time() + 100.0)
    assert exits == []
    # a shrink that began first wins: stop() then says so, and the
    # caller must not finish
    coord = elastic.ElasticCoordinator(
        ckd, lambda: {"cfg": cfg, "params": params, "step": 1},
        d=d, rank=0, world=2, generation=0, monitor=False,
        exit=exits.append)
    coord.shrink({1})
    assert exits == [elastic.SHRINK_EXIT_CODE] and coord.stop() is False
    coord.wait_for_shrink()              # an injected exit returns
    # the first step boundary reserves pinned buffers for CUDA tensors
    # only: none here
    coord.beat(1)
    assert ck._reserve_host_buffers(params.parameters()) == 0


def test_chaos_driven_shrink_and_quarantine(tmp_path):
    """A chaos error at the step site with a stale peer shrinks once; a
    quarantined dead peer shrinks without a capture; a boundary leaves
    with 45."""
    d, ckd = str(tmp_path / "sb"), str(tmp_path / "ck")
    cfg, params, mom = tiny_state()
    exits = []
    elastic.write_generation(d, 0, 2)
    elastic.write_heartbeat(d, 1, 0, wall=time.time() - 30.0)
    coord = elastic.ElasticCoordinator(
        ckd, lambda: {"cfg": cfg, "params": params, "momentum": mom,
                      "step": 3}, d=d, rank=0, world=2, generation=0,
        monitor=False, interval=0.5, miss=2, exit=exits.append)
    chaos.inject("train.step", "error", at=0)
    with pytest.raises(chaos.ChaosError):
        chaos.fire("train.step", step=3)
    coord.check()
    assert exits == [44] and ck.list_shard_generations(ckd) == [(1, 3, 1)]
    q = str(tmp_path / "q")
    elastic.write_generation(q, 0, 2)
    elastic.write_quarantine_record(q, 1, 0, {"evidence": "bitflip"})
    coord = elastic.ElasticCoordinator(
        str(tmp_path / "qck"), lambda: {"cfg": cfg, "params": params,
                                        "step": 5},
        d=q, rank=0, world=2, generation=0, monitor=False,
        exit=exits.append)
    coord.check()
    assert exits == [44, 44] and not os.path.exists(str(tmp_path / "qck"))
    assert elastic.read_shrink_record(q, 1)["quarantined"] == [1]
    elastic.ElasticCoordinator(
        ckd, dict, d=d, rank=0, world=2, generation=0, monitor=False,
        exit=exits.append).leave_at_boundary()
    assert exits[-1] == elastic.BOUNDARY_EXIT_CODE


def test_observe_recovery(tmp_path):
    d = str(tmp_path)
    assert elastic.observe_recovery(generation=0, d=d) is None
    assert elastic.observe_recovery(generation=3, d=d) is None
    elastic.write_shrink_record(d, 2, [0], [1], step=4,
                                wall=time.time() - 1.5)
    ms = elastic.observe_recovery(generation=2, d=d)
    assert ms is not None and 1500.0 <= ms < 60000.0
    elastic.write_generation(d, 5, 2, since_wall=time.time() - 2.5)
    assert 2500.0 <= elastic.observe_recovery(generation=5, d=d) < 60000.0


# ------------------------------------------------------------- cursors --

def _rest(it):
    return [b.data[0].asnumpy() for b in it]


@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_cursor_round_trip(shuffle):
    """The cursor (shuffled order included) survives JSON and restores
    the rest of the epoch, whatever numpy's global stream does between;
    the JSON is JAX's for the same iterator state."""
    data = np.arange(64).astype(np.float32).reshape(16, 4)
    np.random.seed(11)
    it = tio.NDArrayIter(data, batch_size=4, shuffle=shuffle,
                         last_batch_handle="discard")
    it.next()
    state = it.state_dict()
    wire = json.dumps(elastic.jsonable_cursor(state))
    np.random.seed(11)
    jit = jio.NDArrayIter(data, batch_size=4, shuffle=shuffle,
                          last_batch_handle="discard")
    jit.next()
    assert json.loads(wire) == json.loads(json.dumps(
        jel.jsonable_cursor(jit.state_dict())))
    rest = _rest(it)
    np.random.seed(999)
    it2 = tio.NDArrayIter(data, batch_size=4, shuffle=shuffle,
                          last_batch_handle="discard")
    it2.load_state_dict(elastic.cursor_from_json(json.loads(wire)))
    rest2 = _rest(it2)
    assert len(rest) == len(rest2) == 3
    for a, b in zip(rest, rest2):
        np.testing.assert_array_equal(a, b)


def test_image_record_iter_cursor_round_trip(tmp_path):
    path, idx = str(tmp_path / "img.rec"), str(tmp_path / "img.idx")
    w = trec.MXIndexedRecordIO(idx, path, "w")
    rng = np.random.RandomState(0)
    for i in range(8):
        img = rng.randint(0, 255, (8, 8, 3)).astype(np.uint8)
        w.write_idx(i, trec.pack_img(trec.IRHeader(0, float(i), i, 0), img,
                                     img_fmt=".npy"))
    w.close()

    def make():
        return tio.ImageRecordIter(path_imgrec=path, path_imgidx=idx,
                                   data_shape=(3, 8, 8), batch_size=2)
    it = make()
    it.next()
    state = it.state_dict()
    rest = [b.label[0].asnumpy() for b in it]
    it2 = make()
    it2.load_state_dict(state)
    rest2 = [b.label[0].asnumpy() for b in it2]
    assert len(rest) == 3
    for a, b in zip(rest, rest2):
        np.testing.assert_array_equal(a, b)


def test_resize_and_prefetching_iter_cursor_round_trip():
    data = np.arange(48).reshape(12, 4).astype(np.float32)

    def make():
        return tio.PrefetchingIter(tio.ResizeIter(
            tio.NDArrayIter(data, batch_size=3,
                            last_batch_handle="discard"),
            6, reset_internal=True))
    it = make()
    consumed = [it.next().data[0].asnumpy() for _ in range(2)]
    state = it.state_dict()
    rest = _rest(it)
    it2 = make()
    it2.load_state_dict(state)
    rest2 = _rest(it2)
    assert len(consumed) == 2 and len(rest) == len(rest2) == 4
    for a, b in zip(rest, rest2):
        np.testing.assert_array_equal(a, b)
    # the batch in flight in the prefetcher did not move the saved cursor
    assert state["inner"][0]["cur"] == 2


def test_rng_capture_round_trip_across_packages():
    np.random.seed(42)
    np.random.rand(3)
    snap = elastic.capture_rng()
    assert snap == jel.capture_rng()
    a = np.random.rand(5)
    jel.restore_rng(json.loads(json.dumps(snap)))
    np.testing.assert_array_equal(np.random.rand(5), a)
    elastic.restore_rng(snap)
    np.testing.assert_array_equal(np.random.rand(5), a)
    rs = np.random.RandomState(3)
    own = elastic.capture_rng(rs)
    b = rs.rand(4)
    assert elastic.restore_rng(own, rs) is rs
    np.testing.assert_array_equal(rs.rand(4), b)


# ---------------------------------------------- accumulation compensation --

def test_accumulation_factor():
    for base, world in ((4, 2), (2, 2), (8, 1), (6, 3)):
        assert elastic.accumulation_factor(base, world) == \
            jel.accumulation_factor(base, world) == base // world
    with pytest.raises(ValueError, match="evenly"):
        elastic.accumulation_factor(4, 3)
    with pytest.raises(ValueError):
        elastic.accumulation_factor(2, 0)
    assert elastic.keep_global_batch(True) and \
        not elastic.keep_global_batch()


def _tokens(accum, batch=4, seed=3):
    return np.random.RandomState(seed).randint(
        0, CFG["vocab_size"], (accum, batch, CFG["max_len"]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_accum_step_at_1_is_make_train_step_bitwise(dtype):
    cfg, params, _ = tiny_state(dtype=dtype)
    tokens = _tokens(1)
    step = elastic.make_accum_train_step(cfg, lr=LR, accum=1)
    p1, m1, l1 = step(params, ttf.init_momentum(params),
                      torch.from_numpy(tokens))
    p0 = ttf.init_params(cfg, seed=0, device="cpu")
    p0, m0, l0 = ttf.make_train_step(cfg, lr=LR)(
        p0, ttf.init_momentum(p0), tokens[0])
    assert torch.equal(l0, l1)
    for n, t in p0.named_parameters():
        assert torch.equal(dict(p1.named_parameters())[n], t), n
        assert torch.equal(m1[n], m0[n]), n


def test_accum_step_is_deterministic_averages_and_keeps_inputs():
    cfg, params, _ = tiny_state()
    before = {n: t.clone() for n, t in params.named_parameters()}
    mom = ttf.init_momentum(params)
    tokens = torch.from_numpy(_tokens(2))
    step = elastic.make_accum_train_step(cfg, lr=LR, accum=2)
    p1, m1, l1 = step(params, mom, tokens)
    p2, m2, l2 = step(params, mom, tokens)
    assert torch.equal(l1, l2)
    for n, t in p1.named_parameters():
        assert torch.equal(dict(p2.named_parameters())[n], t)
        assert torch.equal(dict(params.named_parameters())[n], before[n])
        assert not torch.any(mom[n])           # no donation
    lf = ttf.loss_fn(params, tokens[0], cfg)
    ls = ttf.loss_fn(params, tokens[1], cfg)
    np.testing.assert_allclose(float(l1), (float(lf) + float(ls)) / 2.0,
                               rtol=1e-6)
    with pytest.raises(ValueError, match="accum"):
        step(params, mom, tokens[:1])
    # donate=True writes in place, the same values
    p3, m3, _ = elastic.make_accum_train_step(cfg, lr=LR, accum=2,
                                              donate=True)(
        params, mom, tokens)
    assert p3 is params and m3 is mom
    for n, t in p1.named_parameters():
        assert torch.equal(dict(params.named_parameters())[n], t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("accum", [1, 2, 4])
def test_accum_step_against_jax(dtype, accum):
    """From JAX's initial weights carried across and JAX's momentum, one
    accumulated step in both packages on the same tokens."""
    jcfg = jtf.TransformerConfig(dtype=getattr(jnp, dtype), **CFG)
    jp = jtf.init_params(jcfg, seed=0)
    rng = np.random.RandomState(5)
    jm = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32) * 0.01), jp)
    tokens = _tokens(accum)
    cfg = convert.config_from_jax(jcfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                     device="cpu")
    mom = convert.momentum_from_jax(jax.tree.map(np.asarray, jm), params)
    jstep = jel.make_accum_train_step(jcfg, lr=LR, accum=accum)
    jp2, jm2, jl = jstep(jp, jm, jnp.asarray(tokens, jnp.int32))
    p2, m2, l2 = elastic.make_accum_train_step(cfg, lr=LR, accum=accum)(
        params, mom, torch.from_numpy(tokens))
    want_p = ttf.flatten_tree(jax.tree.map(
        lambda x: np.asarray(x, np.float32), jp2))
    want_m = ttf.flatten_tree(jax.tree.map(np.asarray, jm2))
    if dtype == "float32":
        np.testing.assert_allclose(float(l2), float(jl), rtol=1e-6)
        for n, t in p2.named_parameters():
            np.testing.assert_allclose(t.numpy(), want_p[n], **TOL32)
            np.testing.assert_allclose(m2[n].numpy(), want_m[n], **TOL32)
        return
    np.testing.assert_allclose(float(l2), float(jl), rtol=1e-4)
    m0 = ttf.flatten_tree(jax.tree.map(np.asarray, jm))
    for n, t in p2.named_parameters():
        got_m = m2[n].numpy()
        grad = want_m[n] - 0.9 * m0[n]
        assert np.linalg.norm(got_m - want_m[n]) <= \
            BF16_GRAD_REL * np.linalg.norm(grad), n
        # each package rounds p - lr * bf16(m) once: the two differ by
        # lr times their momenta's bf16 difference, plus one unit
        got = t.float().numpy()
        bound = LR * (np.abs(got_m - want_m[n]) + 2.0 ** -8 * (
            np.abs(got_m) + np.abs(want_m[n]))) + \
            2.0 ** -7 * np.abs(want_p[n]) + 1e-12
        np.testing.assert_array_less(np.abs(got - want_p[n]), bound)
