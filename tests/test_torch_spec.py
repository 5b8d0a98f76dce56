"""Speculative decoding in the port (``ContinuousBatcher(spec_k=...)`` and
``speculative_generate``) on the CPU, test for test the JAX package's
tests/test_serving_spec.py, at the size of
tests/test_torch_serving_dense.py (vocab 97, d_model 32, 4 heads over 2
KV heads, 2 layers, max_len 64, fp32; the draft model vocab 97, d_model
16, 2 heads, 1 layer). Greedy streams are compared exactly: against the
JAX package's speculative batcher and the port's plain batcher, and
against solo ``generate()``; a round against a numpy oracle fed the
port's own state. Speculation must show only in the dispatch count.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.models import serving as tsv
from mxnet_tpu_torch.models import transformer as ttf
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

jtf = importlib.import_module("mxnet_tpu.models.transformer")
jsv = importlib.import_module("mxnet_tpu.models.serving")

CFG = dict(vocab_size=97, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=64, max_len=64)
DCFG = dict(vocab_size=97, d_model=16, n_heads=2, n_layers=1, d_ff=32,
            max_len=64)
BS = 8

# prompts with internal repetition (the n-gram provider's habitat)
PROMPTS = [[3, 5, 7, 5, 7, 5], [11, 2, 2, 2, 2], [1, 9, 4, 9, 4, 9, 4]]
N_NEW = [12, 10, 14]
JOBS = list(zip(PROMPTS, N_NEW))


@pytest.fixture(scope="module")
def models():
    tcfg, dcfg = ttf.TransformerConfig(**CFG), ttf.TransformerConfig(**DCFG)
    return (tcfg, ttf.init_params(tcfg, seed=3, device="cpu"), dcfg,
            ttf.init_params(dcfg, seed=9, device="cpu"))


@pytest.fixture(scope="module")
def jax_models():
    jcfg, dcfg = jtf.TransformerConfig(**CFG), jtf.TransformerConfig(**DCFG)
    return (jcfg, jtf.init_params(jcfg, seed=3), dcfg,
            jtf.init_params(dcfg, seed=9))


@pytest.fixture(scope="module")
def solo(models):
    tcfg, tp, _, _ = models
    cache = {}

    def run(prompt, n_new):
        key = (tuple(prompt), n_new)
        if key not in cache:
            cache[key] = ttf.generate(tp, np.asarray([prompt]), n_new, tcfg,
                                      device="cpu")[0].tolist()
        return cache[key]
    return run


def _run_pool(srv, jobs):
    """Admissions and steps to the end: {rid: tokens} and the admission
    order (a rid per job, FIFO)."""
    out, order = {}, []
    it = iter(jobs)
    nxt = next(it, None)
    while True:
        while nxt is not None and srv.has_capacity:
            rid = srv.admit(nxt[0], nxt[1])
            if rid is None:
                break
            order.append(rid)
            nxt = next(it, None)
        out.update(srv.step())
        if nxt is None and not srv.active_count:
            break
    return out, order


def test_spec_round_matches_numpy_oracle(models):
    """One round's targets and emit counts against a numpy oracle fed the
    port's state: the n-gram proposal (latest suffix match, the fallback
    off the stream, keff masking), the window's targets by stepped
    decode_step argmax, and the cumprod prefix acceptance."""
    tcfg, tp, _, _ = models
    k, ng = 4, 2
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=3, spec_k=k,
                                spec_ngram=ng, device="cpu")
    for p, n in JOBS:
        assert srv.admit(p, n) is not None
    srv._keff[1] = 2           # the -1 sentinel masking is in the contract
    hist0 = srv._dev_hist.numpy().copy()
    tok0, pos0 = srv._dev_tok.numpy().copy(), srv._dev_pos.numpy().copy()
    keff0 = np.array(srv._keff)
    lanes = [[{n: leaf[i:i + 1].clone() for n, leaf in layer.items()}
              for layer in srv._cache] for i in range(3)]
    out, _, _ = srv._run_spec_rounds(srv._dev_tok, srv._dev_pos,
                                     torch.from_numpy(keff0))
    targets, emits = out[0, :, :-1].numpy(), out[0, :, -1].numpy()
    for b in range(3):
        hist, pos, tok = hist0[b], int(pos0[b]), int(tok0[b])
        hl = hist.shape[0]
        suffix = [hist[max(pos - ng + 1 + o, 0)] for o in range(ng)]
        best = max([j for j in range(hl) if j + ng - 1 < pos
                    and all(hist[(j + o) % hl] == suffix[o]
                            for o in range(ng))], default=-1)
        drafts = []
        for i in range(k):
            g = best + ng + i
            d = int(hist[g]) if best >= 0 and g <= pos else tok
            drafts.append(d if i < keff0[b] else -1)
        cache, oracle = lanes[b], []
        for i, t in enumerate([tok] + [max(d, 0) for d in drafts]):
            logits, cache = ttf.decode_step(
                tp, cache, torch.tensor([t]),
                torch.tensor([pos + i], dtype=torch.int32), tcfg)
            oracle.append(int(torch.argmax(logits[0])))
        assert targets[b].tolist() == oracle
        acc = 0
        while acc < k and drafts[acc] == oracle[acc]:
            acc += 1
        assert int(emits[b]) == acc + 1, (b, drafts, oracle)


@pytest.mark.parametrize("provider", ["ngram", "model"])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("depth", [1, 2])
def test_spec_streams_bitexact(models, jax_models, solo, provider, paged,
                               depth):
    """Every speculative greedy stream equals the JAX speculative
    batcher's, the port's plain batcher's and solo generate()'s — dense
    and paged, depth 1 and 2, both draft providers — with JAX's dispatch
    count and a whole pool at the end."""
    tcfg, tp, dcfg, dp = models
    jcfg, jp, jdcfg, jdp = jax_models
    kw = dict(max_batch=2, pipeline_depth=depth, spec_k=3, paged=paged)
    if paged:
        kw.update(block_size=BS)
    jkw, tkw = dict(kw), dict(kw)
    if provider == "model":
        jkw.update(draft_params=jdp, draft_cfg=jdcfg)
        tkw.update(draft_params=dp, draft_cfg=dcfg)
    jsrv = jsv.ContinuousBatcher(jp, jcfg, **jkw)
    want, want_order = _run_pool(jsrv, JOBS)
    srv = tsv.ContinuousBatcher(tp, tcfg, device="cpu", **tkw)
    out, order = _run_pool(srv, JOBS)
    assert order == want_order and out == want
    assert srv.dispatch_count == jsrv.dispatch_count
    plain, _ = tsv.ContinuousBatcher(tp, tcfg, max_batch=2,
                                     device="cpu").run(JOBS)
    assert [out[r] for r in order] == [plain[r] for r in order]
    for rid, (p, n) in zip(order, JOBS):
        assert out[rid] == solo(p, n)
    if paged:
        assert srv._alloc.free_blocks == srv.num_blocks - 1
        assert srv._alloc.reserved == 0
    srv.check_invariants(quiesce=True)


@pytest.mark.parametrize("paged", [False, True])
def test_spec_mid_flight_eviction(models, solo, paged):
    """cancel() with speculative dispatches in flight: the evicted lane's
    emissions in flight are dropped by rid, the survivor and the
    admission that takes the lane stay exact."""
    tcfg, tp, _, _ = models
    kw = dict(max_batch=2, pipeline_depth=2, spec_k=3, paged=paged)
    if paged:
        kw.update(block_size=BS)
    srv = tsv.ContinuousBatcher(tp, tcfg, device="cpu", **kw)
    r0 = srv.admit(PROMPTS[0], 14)
    r1 = srv.admit(PROMPTS[1], 14)
    done = {}
    done.update(srv.step())
    partial = srv.cancel(r0)
    assert partial is not None
    assert partial == solo(PROMPTS[0], 14)[:len(partial)]
    r2 = srv.admit(PROMPTS[2], 10)
    while r1 not in done or r2 not in done:
        done.update(srv.step())
    assert done[r1] == solo(PROMPTS[1], 14)
    assert done[r2] == solo(PROMPTS[2], 10)


def test_spec_cancel_mid_round_trims_draft_reservation(models, solo):
    """cancel() while a paged verify window is in flight: the lane's whole
    claim, the worst-case draft over-reservation included, returns at
    the cut, its table parks on the null block, and the allocator passes
    its audit at the cut, every step after and at quiesce."""
    tcfg, tp, _, _ = models
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=2, spec_k=3, paged=True,
                                block_size=BS, pipeline_depth=2,
                                device="cpu")
    r0 = srv.admit(PROMPTS[0], 14)
    r1 = srv.admit(PROMPTS[1], 14)
    lane0 = next(i for i, r in enumerate(srv._slots)
                 if r is not None and r.rid == r0)
    done = {}
    done.update(srv.step())
    claim = len(srv._lane_blocks[lane0])
    need = srv._lane_need[lane0]
    assert claim >= 1 and need >= claim
    avail_before = srv._alloc.available
    assert srv.cancel(r0) is not None
    assert srv._alloc.available == avail_before + need
    assert not srv._lane_blocks[lane0] and not srv._lane_need[lane0]
    assert not srv._tables[lane0].any()
    srv.check_invariants()
    while r1 not in done:
        done.update(srv.step())
        srv.check_invariants()
    assert done[r1] == solo(PROMPTS[1], 14)
    assert srv.check_invariants(quiesce=True)


@pytest.mark.parametrize("provider", ["ngram", "model"])
def test_spec_requeue_on_dispatch_failure(models, solo, provider,
                                          monkeypatch):
    """A speculative dispatch that raises: the pool and the draft state
    (history rows, draft pool) are rebuilt, the live requests requeued
    from their synced tokens, and the greedy streams stay exact."""
    tcfg, tp, dcfg, dp = models
    kw = dict(max_batch=2, spec_k=3, paged=True, block_size=BS,
              pipeline_depth=2)
    if provider == "model":
        kw.update(draft_params=dp, draft_cfg=dcfg)
    srv = tsv.ContinuousBatcher(tp, tcfg, device="cpu", **kw)
    r0 = srv.admit(PROMPTS[0], 12)
    r1 = srv.admit(PROMPTS[1], 10)
    done = {}
    done.update(srv.step())
    real, calls = srv._run_spec_rounds, []

    def once(*args):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected dispatch failure")
        return real(*args)

    monkeypatch.setattr(srv, "_run_spec_rounds", once)
    while r0 not in done or r1 not in done:
        done.update(srv.step())
    assert len(calls) > 1
    assert srv._alloc.free_blocks == srv.num_blocks - 1
    assert done[r0] == solo(PROMPTS[0], 12)
    assert done[r1] == solo(PROMPTS[1], 10)


def test_spec_block_release_on_reject(models, solo):
    """Every dispatch reserves worst-case coverage; every sync walks
    ``_sched_pos`` back to the measured acceptance and releases the
    over-materialised tail into reservation. At depth 1 the reconciled
    state is exact after every step."""
    tcfg, tp, _, _ = models
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=2, spec_k=4, paged=True,
                                block_size=BS, device="cpu")
    r0 = srv.admit(PROMPTS[0], 14)
    r1 = srv.admit(PROMPTS[2], 12)
    done = {}
    while r0 not in done or r1 not in done:
        done.update(srv.step())
        held = sum(1 for b in range(1, srv.num_blocks)
                   if srv._alloc.ref[b] > 0)
        assert held + srv._alloc.free_blocks == srv.num_blocks - 1
        for i, req in enumerate(srv._slots):
            if req is None:
                continue
            want = min((int(srv._sched_pos[i]) - 1) // BS + 1,
                       srv._lane_need[i])
            assert len(srv._lane_blocks[i]) == want, (i, want)
            assert srv._alloc.reserved >= \
                srv._lane_need[i] - len(srv._lane_blocks[i])
    assert srv._alloc.free_blocks == srv.num_blocks - 1
    assert srv._alloc.reserved == 0
    assert done[r0] == solo(PROMPTS[0], 14)
    assert done[r1] == solo(PROMPTS[2], 12)


def test_spec_adaptive_k_floor(models, solo):
    """The per-lane controller: a draft model of another init keeps
    missing, its lane's EWMA falls under the floor and k shrinks to 1 (not
    0); the n-gram provider on a looping stream holds k at spec_k.
    Streams stay exact either way."""
    tcfg, tp, dcfg, _ = models
    bad = tsv.ContinuousBatcher(
        tp, tcfg, max_batch=1, spec_k=4, spec_accept_floor=0.6,
        draft_params=ttf.init_params(dcfg, seed=1, device="cpu"),
        draft_cfg=dcfg, device="cpu")
    rid = bad.admit(PROMPTS[0], 16)
    done = {}
    while rid not in done:
        done.update(bad.step())
    assert done[rid] == solo(PROMPTS[0], 16)
    rid = bad.admit(PROMPTS[2], 20)
    shrunk = []
    while True:
        out = bad.step()
        if bad.active_count:
            shrunk.append(int(bad._keff[0]))
        if rid in out:
            break
    assert min(shrunk) == 1, shrunk
    assert bad.health_snapshot()["serving.spec_k_live"] == 4.0   # reset
    good = tsv.ContinuousBatcher(tp, tcfg, max_batch=1, spec_k=4,
                                 spec_accept_floor=0.3, device="cpu")
    rid = good.admit(PROMPTS[1], 16)
    kept = []
    while True:
        out = good.step()
        if good.active_count:
            kept.append(int(good._keff[0]))
        if rid in out:
            break
    assert max(kept) == 4, kept
    assert out[rid] == solo(PROMPTS[1], 16)


def test_spec_option_defaults(models, monkeypatch):
    """The port reads no MXNET_SPEC_* variable (the JAX batcher's
    environment defaults): the options are arguments only, spec_ngram 2
    and spec_accept_floor 0.0 by default, and spec_k unset is off."""
    tcfg, tp, _, _ = models
    monkeypatch.setenv("MXNET_SPEC_K", "3")
    monkeypatch.setenv("MXNET_SPEC_NGRAM", "4")
    monkeypatch.setenv("MXNET_SPEC_ACCEPT_FLOOR", "0.25")
    off = tsv.ContinuousBatcher(tp, tcfg, max_batch=1, device="cpu")
    assert off.spec_k is None and not off._spec_on
    assert off._spec_provider is None
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=1, spec_k=3,
                                device="cpu")
    assert (srv.spec_k, srv.spec_ngram, srv.spec_accept_floor) \
        == (3, 2, 0.0)
    assert srv._spec_provider == "ngram"
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=1, spec_k=3,
                                spec_ngram=4, spec_accept_floor=0.25,
                                device="cpu")
    assert (srv.spec_ngram, srv.spec_accept_floor) == (4, 0.25)


def test_spec_validation(models):
    tcfg, tp, dcfg, dp = models
    with pytest.raises(ValueError, match="greedy-only"):
        tsv.ContinuousBatcher(tp, tcfg, spec_k=2, temperature=0.7,
                              greedy=False, device="cpu")
    with pytest.raises(ValueError, match="pair"):
        tsv.ContinuousBatcher(tp, tcfg, spec_k=2, draft_params=dp,
                              device="cpu")
    small = ttf.TransformerConfig(**dict(DCFG, vocab_size=31))
    with pytest.raises(ValueError, match="vocab"):
        tsv.ContinuousBatcher(
            tp, tcfg, spec_k=2, draft_cfg=small,
            draft_params=ttf.init_params(small, seed=9, device="cpu"),
            device="cpu")
    short = ttf.TransformerConfig(**dict(DCFG, max_len=32))
    with pytest.raises(ValueError, match="max_len"):
        tsv.ContinuousBatcher(
            tp, tcfg, spec_k=2, draft_cfg=short,
            draft_params=ttf.init_params(short, seed=9, device="cpu"),
            device="cpu")
    with pytest.raises(ValueError, match="without spec_k"):
        tsv.ContinuousBatcher(tp, tcfg, draft_params=dp, draft_cfg=dcfg,
                              device="cpu")
    with pytest.raises(ValueError, match="spec_k must be"):
        tsv.ContinuousBatcher(tp, tcfg, spec_k=-1, device="cpu")
    with pytest.raises(ValueError, match="spec_ngram"):
        tsv.ContinuousBatcher(tp, tcfg, spec_k=2, spec_ngram=0, device="cpu")
    srv = tsv.ContinuousBatcher(tp, tcfg, spec_k=2, paged=True, block_size=BS,
                                draft_params=dp, draft_cfg=dcfg, device="cpu")
    with pytest.raises(ValueError, match="prefix sharing"):
        srv.cache_prefix([1, 2, 3])


@pytest.mark.parametrize("paged", [False, True])
def test_spec_off_path_silence(models, solo, paged):
    """spec_k unset changes nothing: the same streams and the same
    dispatch count as the plain batcher, paged or not; speculation
    reduces the dispatches on this workload and keeps the streams."""
    tcfg, tp, _, _ = models

    def drive(**kw):
        srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=2, device="cpu",
                                    **kw)
        out, order = _run_pool(srv, JOBS)
        for rid, (p, n) in zip(order, JOBS):
            assert out[rid] == solo(p, n)
        return srv

    base = drive()
    assert not base._spec_on and base._spec_provider is None
    srv2 = drive(paged=paged, block_size=BS if paged else None)
    assert srv2.dispatch_count == base.dispatch_count
    spec = drive(spec_k=4, paged=paged, block_size=BS if paged else None)
    assert spec.dispatch_count < base.dispatch_count


@pytest.mark.parametrize("k_draft, n_new", [(4, 20), (3, 55)])
def test_speculative_generate_matches_jax(models, jax_models, solo, k_draft,
                                          n_new):
    """Solo speculative decoding: the port's tokens and stats (per-round
    acceptances, big-model launches) are JAX's, and the tokens are
    greedy generate()'s; at n_new 55 of max_len 64 k is clamped near the
    end."""
    tcfg, tp, dcfg, dp = models
    jcfg, jp, jdcfg, jdp = jax_models
    prompt = [PROMPTS[0]]
    jout, jstats = jtf.speculative_generate(
        jp, jdp, jnp.asarray(prompt, jnp.int32), n_new, jcfg, jdcfg,
        k_draft=k_draft, return_stats=True)
    out, stats = ttf.speculative_generate(tp, dp, prompt, n_new, tcfg, dcfg,
                                          k_draft=k_draft, return_stats=True,
                                          device="cpu")
    assert out.dtype == torch.int32 and out.shape == (1, 6 + n_new)
    assert out.tolist() == np.asarray(jout).tolist()
    assert stats == jstats
    assert out[0].tolist() == solo(PROMPTS[0], n_new)
    assert ttf.speculative_generate(tp, dp, prompt, n_new, tcfg, dcfg,
                                    k_draft=k_draft,
                                    device="cpu").tolist() == out.tolist()


def test_speculative_generate_validation(models):
    tcfg, tp, dcfg, dp = models
    with pytest.raises(ValueError, match="batch=1"):
        ttf.speculative_generate(tp, dp, [[1, 2], [3, 4]], 4, tcfg, dcfg,
                                 device="cpu")
    small = ttf.TransformerConfig(**dict(DCFG, vocab_size=31))
    with pytest.raises(ValueError, match="vocab"):
        ttf.speculative_generate(
            tp, ttf.init_params(small, device="cpu"), [[1, 2]], 4, tcfg,
            small, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        ttf.speculative_generate(tp, dp, [[1, 2]], 63, tcfg, dcfg,
                                 device="cpu")
    with pytest.raises(ValueError, match="n_new"):
        ttf.speculative_generate(tp, dp, [[1, 2]], 0, tcfg, dcfg,
                                 device="cpu")
