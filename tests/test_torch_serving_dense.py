"""The port's dense-lane continuous batcher (``paged=False``, the default)
held against the JAX package's on the CPU, at the size of
tests/test_torch_serving.py (vocab 97, d_model 32, 4 heads over 2 KV
heads, 2 layers, max_len 64, fp32): greedy streams equal JAX's token for
token, sampled streams too when the port draws JAX's noise, and each
request's stream equals its solo ``generate()``. Also the lifecycle:
slot reuse, mid-stream admission, ``cancel``, ``stream`` and stop tokens,
and the JAX batcher's argument order and default layout.
"""

import importlib
import inspect

import jax
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
V = CFG["vocab_size"]
SAMPLE = dict(temperature=0.8, top_k=30, top_p=0.9)


def _models(seed, **over):
    jcfg = jtf.TransformerConfig(**dict(CFG, **over))
    tcfg = ttf.TransformerConfig(**dict(CFG, **over))
    return (jcfg, jtf.init_params(jcfg, seed=seed), tcfg,
            ttf.init_params(tcfg, seed=seed, device="cpu"))


def _jobs(seed, with_seeds=False):
    """More requests than lanes, prompts of two bucket widths."""
    rng = np.random.RandomState(seed)
    jobs = [([int(t) for t in rng.randint(0, V, n)], m)
            for n, m in zip([3, 12, 5, 14, 1], [9, 4, 17, 6, 2])]
    if with_seeds:
        jobs = [job + (100 + i,) for i, job in enumerate(jobs)]
    return jobs


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


def _smallest_gap(params, cfg, streams):
    """Smallest top-1/top-2 gap over the JAX streams' generated rows."""
    gaps = []
    for toks, t_p in streams:
        logits, _ = jtf.prefill_chunk(params, jtf.init_cache(cfg, 1),
                                      jnp.asarray([toks[:-1]]), 0, cfg)
        top = np.sort(np.asarray(logits[0, t_p - 1:], np.float64), -1)
        gaps.append(float((top[:, -1] - top[:, -2]).min()))
    return min(gaps)


def _solo(tp, tcfg, prompt, n_new, **kw):
    return ttf.generate(tp, np.asarray([prompt]), n_new, tcfg, device="cpu",
                        **kw)[0].tolist()


@pytest.mark.parametrize("flash", [False, True])
def test_dense_lanes_match_jax(flash, monkeypatch):
    """Dense lanes give JAX's dense-lane streams and admission order;
    under use_flash_kernel every decode step reaches the flash-decode
    wrapper once per layer with each lane's position + 1 as its
    length."""
    jcfg, jp, tcfg, tp = _models(11, use_flash_kernel=flash)
    jobs = _jobs(12)
    want, want_order = jsv.ContinuousBatcher(jp, jcfg, max_batch=3,
                                             paged=False).run(jobs)
    lengths = []
    real = ttf.flash_decode

    def counted(q, k, v, n):
        lengths.append(n.clone())
        return real(q, k, v, n)

    monkeypatch.setattr(ttf, "flash_decode", counted)
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=3, device="cpu")
    got, order = srv.run(jobs)
    assert order == want_order
    if got != want:
        gap = _smallest_gap(jp, jcfg, [(want[r], len(jobs[i][0]))
                                       for i, r in enumerate(want_order)])
        pytest.fail("streams differ; smallest top-1/top-2 gap on the JAX "
                    "streams: %g" % gap)
    assert not srv.paged and srv.free_blocks is None
    srv.check_invariants(quiesce=True)
    assert len(lengths) == (CFG["n_layers"] * srv.dispatch_count
                            if flash else 0)
    if flash:
        assert all(n.dtype == torch.int32 and n.shape == (3,)
                   for n in lengths)


def test_dense_sampled_streams_match_jax(monkeypatch):
    """With JAX's key chain replayed, sampled dense-lane streams are
    JAX's; with the port's own noise each equals its solo
    generate(seed)."""
    jcfg, jp, tcfg, tp = _models(11)
    jobs = _jobs(12, with_seeds=True)
    want, _ = jsv.ContinuousBatcher(jp, jcfg, max_batch=3, paged=False,
                                    **SAMPLE).run(jobs)
    with monkeypatch.context() as m:
        m.setattr(ttf, "_gumbel", replayed_gumbel(1))
        got, _ = tsv.ContinuousBatcher(tp, tcfg, max_batch=3, device="cpu",
                                       **SAMPLE).run(jobs)
    assert got == want
    own, order = tsv.ContinuousBatcher(tp, tcfg, max_batch=3, device="cpu",
                                       **SAMPLE).run(jobs)
    for rid, (prompt, n_new, seed) in zip(order, jobs):
        assert own[rid] == _solo(tp, tcfg, prompt, n_new, seed=seed,
                                 **SAMPLE)


def test_default_layout_and_argument_order_are_the_references():
    """C10: with no ``paged`` the batcher builds dense lanes, as the JAX
    batcher does with MXNET_KV_PAGED unset. C8: admit()'s third argument
    is ``seed`` and a job is (prompt, n_new[, seed[, stop_token[,
    priority]]]), so the job (p, n, 0, stop) stops at ``stop`` in both
    packages."""
    jcfg, jp, tcfg, tp = _models(4)
    assert tsv.ContinuousBatcher(tp, tcfg, device="cpu").paged is False
    assert jsv.ContinuousBatcher(jp, jcfg).paged is False
    names = list(inspect.signature(tsv.ContinuousBatcher.admit).parameters)
    want = list(inspect.signature(jsv.ContinuousBatcher.admit).parameters)
    assert names == want
    prompt = [5, 6, 7]
    solo = _solo(tp, tcfg, prompt, 8)
    stop = solo[5]                               # the third new token
    jobs = [(prompt, 8, 0, stop), (prompt, 8, 1)]
    jout, jorder = jsv.ContinuousBatcher(jp, jcfg, max_batch=2).run(jobs)
    out, order = tsv.ContinuousBatcher(tp, tcfg, max_batch=2,
                                       device="cpu").run(jobs)
    assert out == jout and order == jorder
    assert out[order[0]] == solo[:solo.index(stop, 3) + 1]
    assert out[order[1]] == solo
    srv = tsv.ContinuousBatcher(tp, tcfg, temperature=0.9, device="cpu")
    a = srv.admit(prompt, 6, 7)
    b = srv.admit(prompt, 6, seed=7)
    done = {}
    while srv.active_count:
        done.update(srv.step())
    assert done[a] == done[b] == _solo(tp, tcfg, prompt, 6, seed=7,
                                       temperature=0.9)


def test_slot_reuse_clears_the_previous_occupant():
    """Waves through ONE lane: each admission copies the whole row, so
    past the new prompt's bucket the lane holds zeros, not the previous
    occupant's K/V, and every stream equals its solo generate()."""
    _, _, tcfg, tp = _models(5)
    rng = np.random.RandomState(2)
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=1, device="cpu")
    for n_tok, n_new in ((14, 30), (3, 6), (9, 12)):
        prompt = [int(t) for t in rng.randint(1, V, n_tok)]
        rid = srv.admit(prompt, n_new)
        assert rid is not None
        assert srv.admit([1, 2], 2) is None      # the lane is taken
        width = tsv._bucket(n_tok)
        for layer in srv._cache:
            assert not layer["k"][0, width:].any()
            assert not layer["v"][0, width:].any()
        out = {}
        while rid not in out:
            out.update(srv.step())
        assert out[rid] == _solo(tp, tcfg, prompt, n_new)


def test_mid_stream_admission_leaves_running_streams_alone():
    _, _, tcfg, tp = _models(7)
    rng = np.random.RandomState(3)
    p1, p2 = ([int(t) for t in rng.randint(1, V, n)] for n in (6, 10))
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=2, device="cpu")
    r1 = srv.admit(p1, 8)
    done = {}
    done.update(srv.step())
    done.update(srv.step())                      # r1 two tokens in
    r2 = srv.admit(p2, 4)
    while r1 not in done or r2 not in done:
        done.update(srv.step())
    assert done[r1] == _solo(tp, tcfg, p1, 8)
    assert done[r2] == _solo(tp, tcfg, p2, 4)


def test_cancel_frees_the_lane_without_perturbing_others():
    _, _, tcfg, tp = _models(21)
    rng = np.random.RandomState(7)
    p1, p2, p3 = ([int(t) for t in rng.randint(1, V, n)] for n in (5, 8, 4))
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=2, device="cpu")
    r1, r2 = srv.admit(p1, 12), srv.admit(p2, 12)
    done = {}
    for _ in range(3):
        done.update(srv.step())
    partial = srv.cancel(r1)
    assert partial == _solo(tp, tcfg, p1, 12)[:len(partial)]
    assert len(partial) == len(p1) + 4
    assert srv.cancel(r1) is None and srv.cancel(999) is None
    assert srv._pos[0] == 0 and srv._tok[0] == 0    # parked
    r3 = srv.admit(p3, 5)                            # reuses the lane
    while r2 not in done or r3 not in done:
        done.update(srv.step())
    assert r1 not in done
    assert done[r2] == _solo(tp, tcfg, p2, 12)
    assert done[r3] == _solo(tp, tcfg, p3, 5)
    srv.check_invariants(quiesce=True)


@pytest.mark.parametrize("chunk", [1, 4])
def test_stream_events_and_stop_tokens(chunk):
    """stream() yields each request's tokens as run() returns them, the
    first at admission, ``done`` on the last; a stop token ends a
    request with the tail of its chunk discarded; a request cancelled
    between yields gets one terminal (rid, None, True)."""
    _, _, tcfg, tp = _models(3)
    prompt = [5, 9, 2]
    ref = _solo(tp, tcfg, prompt, 12)[len(prompt):]
    stop = ref[5]
    want = ref[:ref.index(stop) + 1]
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=2, chunk_size=chunk,
                                device="cpu")
    events = list(srv.stream([(prompt, 12, 0, stop), (prompt, 3)]))
    first = [t for r, t, _ in events if r == 0]
    assert first == want
    assert [d for r, _, d in events if r == 0] == \
        [False] * (len(want) - 1) + [True]
    assert [t for r, t, _ in events if r == 1] == ref[:3]
    srv.check_invariants(quiesce=True)

    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=2, chunk_size=chunk,
                                device="cpu")
    seen = []
    for rid, tok, done in srv.stream([(prompt, 20), ([1, 2, 3], 6)]):
        seen.append((rid, tok, done))
        if [r for r, _, _ in seen].count(0) == 3:
            assert srv.cancel(0) is not None
    assert seen.count((0, None, True)) == 1
    assert [e for e in seen if e[0] == 0][-1] == (0, None, True)
    assert [t for r, t, _ in seen if r == 1] == \
        _solo(tp, tcfg, [1, 2, 3], 6)[3:]


def test_one_token_requests_and_validation():
    _, _, tcfg, tp = _models(4)
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=2, device="cpu")
    rid = srv.admit([4, 5, 6], 1)
    assert srv.dispatch_count == 0
    assert srv.step() == {rid: _solo(tp, tcfg, [4, 5, 6], 1)}
    assert srv.dispatch_count == 0
    with pytest.raises(ValueError, match="n_new"):
        srv.admit([1], 0)
    with pytest.raises(ValueError, match="empty"):
        srv.admit([], 2)
    with pytest.raises(ValueError, match="max_len"):
        srv.admit([1] * 60, 5)
    # a bucket past max_len clamps: a 40-token prompt prefills at 64 - 0
    long = [int(t) for t in np.random.RandomState(9).randint(1, V, 40)]
    rid = srv.admit(long, 24)
    out = {}
    while srv.active_count:
        out.update(srv.step())
    assert out[rid] == _solo(tp, tcfg, long, 24)
