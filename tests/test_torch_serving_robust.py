"""The port batcher's robustness surface held against the JAX package's on
the CPU, at the size of tests/test_torch_serving_dense.py (vocab 97,
d_model 32, 4 heads over 2 KV heads, 2 layers, max_len 64, fp32; paged
pools of 8-position blocks): priority preemption and
``admit_continuation`` (greedy, and sampled with JAX's noise replayed
into the port), the elastic pool (``shrink_pool`` / ``grow_pool`` and the
allocator's parked ledger), the requeue of a failed dispatch,
idempotency keys, ``health_snapshot`` and ``weight_fingerprint``. The
same call sequence drives both batchers; streams are compared exactly.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.models import convert
from mxnet_tpu_torch.models import serving as tsv
from mxnet_tpu_torch.models import transformer as ttf
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

jtf = importlib.import_module("mxnet_tpu.models.transformer")
jsv = importlib.import_module("mxnet_tpu.models.serving")

CFG = dict(vocab_size=97, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=64, max_len=64)
V = CFG["vocab_size"]
BS = 8
SAMPLE = dict(temperature=0.8, top_k=30, top_p=0.9)
# 12 usable blocks: two 40-token requests (5 blocks each) leave 2
POOL = dict(paged=True, block_size=BS, num_blocks=13)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jtf.TransformerConfig(**CFG), ttf.TransformerConfig(**CFG)
    return (jcfg, jtf.init_params(jcfg, seed=11), tcfg,
            ttf.init_params(tcfg, seed=11, device="cpu"))


def replayed_gumbel(batch):
    """``ttf._gumbel`` drawing JAX's noise (see tests/test_torch_sampling.py):
    token t of seed s uses the t-th sub-key of PRNGKey(s)."""
    cache = {}

    def noise(seed, t):
        if (seed, t) not in cache:
            key = jax.random.PRNGKey(seed)
            for _ in range(t + 1):
                key, sub = jax.random.split(key)
            cache[(seed, t)] = np.array(
                jax.random.gumbel(sub, (batch, V), jnp.float32))
        return cache[(seed, t)]

    def gumbel(seeds, counters, rows, vocab, device):
        return torch.from_numpy(np.stack([
            noise(s, c)[r] for s, c, r in zip(seeds.tolist(),
                                              counters.tolist(),
                                              rows.tolist())])).to(device)
    return gumbel


def _prompts():
    rng = np.random.RandomState(3)
    return [[int(t) for t in rng.randint(1, V, n)] for n in (10, 9, 6, 12)]


def _preempt_drive(srv):
    """Two long requests fill the pool, decode 3 steps, then a priority-1
    admission preempts the younger; the victim resumes through
    admit_continuation once blocks free. Returns ({rid: tokens}, rids,
    the victim's synced tokens at the preemption)."""
    p = _prompts()
    r0 = srv.admit(p[0], 30, seed=7)
    r1 = srv.admit(p[1], 30, seed=8)
    out = {}
    for _ in range(3):
        out.update(srv.step())
    r2 = srv.admit(p[2], 20, seed=9, priority=1)
    assert r2 is not None
    assert [r.rid for r, _ in srv.preempted] == [r1]
    victim, _ = srv.preempted.pop(0)
    synced = list(victim.tokens)
    resumed = None
    while resumed is None or srv.active_count:
        if resumed is None:
            resumed = srv.admit_continuation(
                victim.tokens, victim.n_new - victim.emitted,
                seed=victim.seed, emitted=victim.emitted,
                stop_token=victim.stop_token, priority=victim.priority,
                key=victim.key)
            assert resumed is not None or srv.active_count
        out.update(srv.step())
    return out, (r0, r1, r2, resumed), synced


@pytest.mark.parametrize("sampled", [False, True])
def test_preemption_and_continuation_match_jax(models, sampled, monkeypatch):
    """The same preemption in both batchers: the same victim, the same
    synced prefix, the same streams (sampled ones with JAX's key chain
    replayed into the port: a continuation resumes the chain at
    ``emitted``); and with the port's own noise the resumed stream equals
    its uninterrupted solo generate(seed), at depth 1 and 2."""
    jcfg, jp, tcfg, tp = models
    controls = SAMPLE if sampled else {}
    want, want_rids, want_synced = _preempt_drive(
        jsv.ContinuousBatcher(jp, jcfg, max_batch=3, **POOL, **controls))
    with monkeypatch.context() as m:
        m.setattr(ttf, "_gumbel", replayed_gumbel(1))
        srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=3, device="cpu",
                                    **POOL, **controls)
        got, rids, synced = _preempt_drive(srv)
    assert rids == want_rids and synced == want_synced
    assert got == want
    srv.check_invariants(quiesce=True)
    p = _prompts()
    for depth in (1, 2):
        srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=3, device="cpu",
                                    pipeline_depth=depth, **POOL, **controls)
        own, (r0, _, r2, resumed), _ = _preempt_drive(srv)
        srv.check_invariants(quiesce=True)
        for rid, prompt, n_new, seed in ((r0, p[0], 30, 7),
                                         (resumed, p[1], 30, 8),
                                         (r2, p[2], 20, 9)):
            assert own[rid] == ttf.generate(
                tp, np.asarray([prompt]), n_new, tcfg, seed=seed,
                device="cpu", **controls)[0].tolist()


def test_run_resumes_preempted_requests_under_their_rid(models):
    """run() admits a priority job that preempts, resumes the victim after
    the round's new admissions, and reports it under its original rid:
    JAX's results and order."""
    jcfg, jp, tcfg, tp = models
    p = _prompts()
    jobs = [(p[0], 30, 0, None, 0), (p[1], 30, 0, None, 0),
            (p[2], 20, 0, None, 1), (p[3], 8)]
    want = jsv.ContinuousBatcher(jp, jcfg, max_batch=3, **POOL).run(jobs)
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=3, device="cpu", **POOL)
    assert srv.run(jobs) == want
    assert not srv.preempted
    srv.check_invariants(quiesce=True)


def _elastic_drive(srv):
    """Prefix cached, one request admitted, then a shrink within the free
    blocks, a shrink past them (evicting the prefix and preempting the
    lane) and a grow past the parked ledger; the victim resumes."""
    p = _prompts()
    srv.cache_prefix(p[3])
    r0 = srv.admit(p[0], 30)
    out = {}
    for _ in range(2):
        out.update(srv.step())
    seen = [srv.shrink_pool(3), srv.free_blocks, srv._alloc.parked_blocks]
    srv.check_invariants()
    seen += [srv.shrink_pool(10), srv.free_blocks, srv._alloc.parked_blocks,
             [r.rid for r, _ in srv.preempted], len(srv._prefix_cache)]
    srv.check_invariants()
    seen += [srv.grow_pool(15), srv.num_blocks, srv.free_blocks,
             srv._alloc.parked_blocks, srv.health_snapshot()]
    srv.check_invariants()
    victim, _ = srv.preempted.pop(0)
    rid = srv.admit_continuation(victim.tokens, victim.n_new - victim.emitted,
                                 emitted=victim.emitted)
    while srv.active_count:
        out.update(srv.step())
    srv.check_invariants(quiesce=True)
    return out, rid, r0, seen


def test_shrink_grow_pool_match_jax(models):
    jcfg, jp, tcfg, tp = models
    want = _elastic_drive(jsv.ContinuousBatcher(jp, jcfg, max_batch=3,
                                                **POOL))
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=3, device="cpu", **POOL)
    got = _elastic_drive(srv)
    assert got == want
    out, rid, _, seen = got
    assert seen[9] == 13 + 15 - 12 and len(srv._pool[0]["k"]) == seen[9]
    p = _prompts()
    assert out[rid] == ttf.generate(tp, np.asarray([p[0]]), 30, tcfg,
                                    device="cpu")[0].tolist()
    assert srv.shrink_pool(0) == 0 and srv.grow_pool(0) == 0
    dense = tsv.ContinuousBatcher(tp, tcfg, device="cpu")
    assert dense.shrink_pool(4) == 0 and dense.grow_pool(4) == 0


def test_allocator_parked_ledger_matches_jax():
    """shrink never parks below the reservation, grow returns parked
    blocks, extend frees new ids handed out last; the audit counts
    parked blocks and catches a block both parked and free."""
    calls = [("alloc", 3), ("reserve", 4), ("shrink", 9), ("grow", 2),
             ("extend", 3), ("alloc", 2), ("shrink", 1), ("grow", 9)]
    runs = []
    for mod in (jsv, tsv):
        a = mod.BlockAllocator(12)
        trace = []
        for name, n in calls:
            trace.append((name, getattr(a, name)(n), a.free_blocks,
                          a.parked_blocks, a.available, a.num_blocks))
            a.check_invariants()
        runs.append((trace, list(a._free), a.ref.tolist()))
    assert runs[0] == runs[1]
    a = tsv.BlockAllocator(6)
    a.shrink(2)
    a._free.append(a._parked[0])
    with pytest.raises(RuntimeError, match="both parked and free"):
        a.check_invariants()
    a = tsv.BlockAllocator(6)
    a.shrink(2)
    a.check_invariants(quiesce=True)


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("depth", [1, 2])
def test_requeue_on_a_failed_dispatch(models, layout, depth, monkeypatch):
    """A chunk that raises once: the lanes are rebuilt, the live requests
    requeued from their synced tokens, and every stream, greedy and
    sampled (the noise counter resumes where the chain stood), equals the
    run without the failure; greedy equals the JAX batcher's."""
    jcfg, jp, tcfg, tp = models
    kw = dict(paged=True, block_size=BS) if layout == "paged" \
        else dict(paged=False)
    jobs = [(p, n, 20 + i) for i, (p, n) in enumerate(
        zip(_prompts(), (14, 9, 17, 6)))]
    for controls in ({}, SAMPLE):
        clean, order = tsv.ContinuousBatcher(
            tp, tcfg, max_batch=3, pipeline_depth=depth, device="cpu",
            **kw, **controls).run(jobs)
        srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=3, chunk_size=2,
                                    pipeline_depth=depth, device="cpu",
                                    **kw, **controls)
        real, calls = srv._run_chunk, []

        def once(*args):
            calls.append(1)
            if len(calls) == 3:
                raise RuntimeError("injected dispatch failure")
            return real(*args)

        monkeypatch.setattr(srv, "_run_chunk", once)
        got, got_order = srv.run(jobs)
        assert len(calls) > 3 and srv._dispatch_failures == 0
        assert srv.dispatch_failures == 1
        assert got_order == order and got == clean
        srv.check_invariants(quiesce=True)
        if not controls and layout == "paged" and depth == 1:
            want, _ = jsv.ContinuousBatcher(jp, jcfg, max_batch=3,
                                            **kw).run(jobs)
            assert got == want


def test_requeue_gives_up(models, monkeypatch):
    """Three failed dispatches in a row are requeued, the fourth re-raises;
    a failure that loses the CUDA context re-raises at once."""
    _, _, tcfg, tp = models
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=2, device="cpu")
    srv.admit(_prompts()[0], 10)
    calls = []

    def always(*args):
        calls.append(1)
        raise RuntimeError("injected dispatch failure")

    monkeypatch.setattr(srv, "_run_chunk", always)
    for _ in range(3):
        assert srv.step() == {}
        assert srv.active_count == 1
    with pytest.raises(RuntimeError, match="injected"):
        srv.step()
    assert len(calls) == 4
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=2, device="cpu")
    srv.admit(_prompts()[0], 10)
    monkeypatch.setattr(srv, "_run_chunk", always)
    monkeypatch.setattr(tsv, "_context_lost", lambda device: True)
    with pytest.raises(RuntimeError, match="injected"):
        srv.step()
    assert srv._dispatch_failures == srv.dispatch_failures == 1
    srv.reset_lanes()
    assert srv._dispatch_failures == 0 and srv.dispatch_failures == 1


def test_sticky_cuda_errors_are_recognised(monkeypatch):
    """The context counts as lost exactly when the device's next
    synchronisation raises; a CPU batcher never loses one."""
    cuda = torch.device("cuda", 0)
    synced = []

    def sticky(device):
        synced.append(device)
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(torch.cuda, "synchronize", sticky)
    assert tsv._context_lost(cuda) and synced == [cuda]
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    assert not tsv._context_lost(cuda) and synced == [cuda, cuda]
    assert not tsv._context_lost(torch.device("cpu"))
    assert len(synced) == 2


def _keys_drive(srv):
    p = _prompts()
    seen = [srv.admit(p[0], 5, key="a"), srv.admit(p[1], 5, key="a"),
            srv.active_count]
    out = {}
    while srv.active_count:
        out.update(srv.step())
    seen.append(out)
    seen += [srv.admit(p[2], 3, key="a"), srv.active_count, srv.step()]
    b = srv.admit(p[1], 6, key="b")
    seen += [b, srv.cancel(b), srv.admit(p[1], 6, key="b"),
             srv.active_count]
    while srv.active_count:
        seen.append(srv.step())
    return seen


def test_idempotency_keys_match_jax(models):
    """A duplicate key returns the live request's rid without a second
    admission; once it finished, the original rid again, its tokens
    re-delivered by the next step(); a cancelled request frees its key."""
    jcfg, jp, tcfg, tp = models
    want = _keys_drive(jsv.ContinuousBatcher(jp, jcfg, max_batch=2))
    got = _keys_drive(tsv.ContinuousBatcher(tp, tcfg, max_batch=2,
                                            device="cpu"))
    assert got == want
    assert got[0] == got[1] == got[4] and got[5] == 0


@pytest.mark.parametrize("kw", [
    {}, dict(paged=True, block_size=BS),
    dict(paged=True, block_size=BS, spec_k=3),
])
def test_health_snapshot_matches_jax(models, kw):
    """The snapshot's keys and values are JAX's (parked blocks after a
    shrink, the speculative ratios under spec_k); the SLO attainment is
    None, as JAX's before any completion."""
    jcfg, jp, tcfg, tp = models
    jsrv = jsv.ContinuousBatcher(jp, jcfg, max_batch=2, **kw)
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=2, device="cpu", **kw)
    for s in (jsrv, srv):
        s.admit(_prompts()[0], 6)
        s.step()
        s.shrink_pool(2)
    want, got = jsrv.health_snapshot(), srv.health_snapshot()
    assert sorted(got) == sorted(want)
    assert got["serving.slo_attainment"] is None
    for name, value in want.items():
        if name != "serving.slo_attainment":
            assert got[name] == value, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_fingerprint_matches_jax(dtype):
    """The same weights give JAX's 8-hex id: fp32 from one seed, bf16
    carried across bit for bit (bf16's dtype name and 2-byte words)."""
    jcfg = jtf.TransformerConfig(**dict(CFG, dtype=getattr(jnp, dtype)))
    tcfg = ttf.TransformerConfig(**dict(CFG, dtype=getattr(torch, dtype)))
    jp = jtf.init_params(jcfg, seed=4)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    want = jsv.ContinuousBatcher(jp, jcfg).weight_fingerprint
    srv = tsv.ContinuousBatcher(tp, tcfg, device="cpu")
    assert srv.weight_fingerprint == want
    assert len(want) == 8 and int(want, 16) < 2 ** 32
    assert tsv.params_fingerprint(tp) == want
    with torch.no_grad():
        tp.layers[1].wq[0, 0, 0] += 1
    assert tsv.params_fingerprint(tp) != want


def test_reset_lanes_drops_everything(models):
    _, _, tcfg, tp = models
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=3, device="cpu", **POOL)
    p = _prompts()
    srv.admit(p[0], 30)
    srv.admit(p[1], 30)
    srv.step()
    srv.admit(p[2], 20, priority=1)
    assert srv.preempted
    srv.reset_lanes()
    assert srv.active_count == 0 and not srv.preempted
    srv.check_invariants(quiesce=True)
    rid = srv.admit(p[0], 4)
    out = {}
    while srv.active_count:
        out.update(srv.step())
    assert out[rid] == ttf.generate(tp, np.asarray([p[0]]), 4, tcfg,
                                    device="cpu")[0].tolist()
