"""The port's paged continuous batcher held against the JAX package's, on
the CPU, at a small size (vocab 97, d_model 32, 4 heads over 2 KV heads,
2 layers, max_len 64, 8-position blocks, fp32): the same seeded job mix
gives the same greedy streams token for token, and the block accounting
balances. Dense lanes, sampling, chunked and pipelined dispatch and prefix
caching have their own files: tests/test_torch_serving_*.py,
tests/test_torch_sampling.py and tests/test_torch_prefix_cache.py.
"""

import importlib

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
BS = 8


def _jobs(seed, n=5):
    """More requests than lanes, prompts of two bucket widths, streams
    that cross block edges during decode. (Two buckets and two initial
    block counts keep the JAX batcher's compiles few.)"""
    rng = np.random.RandomState(seed)
    lens = [3, 12, 5, 14, 1][:n]
    budgets = [9, 4, 17, 6, 2][:n]
    return [([int(t) for t in rng.randint(0, 97, n_tok)], m)
            for n_tok, m in zip(lens, budgets)]


def _smallest_gap(params, cfg, streams):
    """Smallest top-1/top-2 gap over the JAX streams' generated rows."""
    import jax.numpy as jnp
    gaps = []
    for toks, t_p in streams:
        logits, _ = jtf.prefill_chunk(params, jtf.init_cache(cfg, 1),
                                      jnp.asarray([toks[:-1]]), 0, cfg)
        top = np.sort(np.asarray(logits[0, t_p - 1:], np.float64), -1)
        gaps.append(float((top[:, -1] - top[:, -2]).min()))
    return min(gaps)


def test_batcher_streams_match_jax():
    jcfg = jtf.TransformerConfig(**CFG)
    tcfg = ttf.TransformerConfig(**CFG)
    jp = jtf.init_params(jcfg, seed=11)
    tp = ttf.init_params(tcfg, seed=11, device="cpu")
    jobs = _jobs(12)
    want, want_order = jsv.ContinuousBatcher(
        jp, jcfg, max_batch=3, paged=True, block_size=BS).run(jobs)
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=3, paged=True,
                                block_size=BS, device="cpu")
    got, order = srv.run(jobs)
    assert order == want_order
    if got != want:
        gap = _smallest_gap(jp, jcfg, [(want[r], len(jobs[i][0]))
                                       for i, r in enumerate(want_order)])
        pytest.fail("streams differ; smallest top-1/top-2 gap on the JAX "
                    "streams: %g" % gap)
    for rid, (prompt, n_new) in zip(order, jobs):
        assert len(got[rid]) == len(prompt) + n_new
    srv.check_invariants(quiesce=True)
    assert srv.free_blocks == srv.num_blocks - 1
    assert srv.dispatch_count > 0


def test_batcher_stream_equals_solo_generate():
    tcfg = ttf.TransformerConfig(**CFG)
    tp = ttf.init_params(tcfg, seed=3, device="cpu")
    prompt = list(np.random.RandomState(3).randint(0, 97, 13))
    solo = ttf.generate(tp, np.asarray([prompt]), 10, tcfg, device="cpu")
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=2, paged=True,
                                block_size=BS, device="cpu")
    rid = srv.admit(prompt, 10)
    out = {}
    while srv.active_count:
        out.update(srv.step())
    assert out[rid] == solo[0].tolist()


def test_block_accounting_and_admission_refusal():
    """Admission reserves a request's lifetime in blocks: a pool too
    small for a second request refuses it (None) until the first one
    finishes, blocks allocate lazily as positions cross block edges, and
    a freed lane parks on the null block."""
    tcfg = ttf.TransformerConfig(**CFG)
    tp = ttf.init_params(tcfg, seed=0, device="cpu")
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=2, paged=True,
                                block_size=BS, num_blocks=6, device="cpu")
    # lifetime: positions up to 5 + 20 - 2 = 23 -> 3 blocks, 1 up front
    rid = srv.admit([1, 2, 3, 4, 5], 20)
    assert srv._alloc.available == 5 - 3 and srv.free_blocks == 4
    assert srv.admit([7] * 9, 12) is None        # needs 3 blocks, 2 left
    with pytest.raises(ValueError, match="KV blocks"):
        srv.admit([7] * 40, 20)                  # 8 blocks > 5 usable
    srv.check_invariants()
    done = {}
    while srv.active_count:
        done.update(srv.step())
        srv.check_invariants()
    assert len(done[rid]) == 25
    assert not srv._tables.any() and srv._pos.tolist() == [0, 0]
    srv.check_invariants(quiesce=True)
    assert srv.admit([7] * 9, 12) is not None


def test_stop_token_and_one_token_requests():
    tcfg = ttf.TransformerConfig(**CFG)
    tp = ttf.init_params(tcfg, seed=4, device="cpu")
    prompt = [5, 6, 7]
    solo = ttf.generate(tp, np.asarray([prompt]), 6, tcfg, device="cpu")
    stop = int(solo[0, 5])                       # the third new token
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=2, paged=True,
                                block_size=BS, device="cpu")
    # jobs are (prompt, n_new[, seed[, stop_token]]), as in the JAX batcher
    out, order = srv.run([(prompt, 6, 0, stop), (prompt, 1)])
    first = solo[0].tolist()
    assert out[order[0]] == first[:first.index(stop, 3) + 1]
    assert out[order[1]] == first[:4]
    srv.check_invariants(quiesce=True)


def test_allocator_invariants_catch_leaks():
    a = tsv.BlockAllocator(5)
    ids = a.alloc(2)
    a.reserve(1)
    a.check_invariants(mappings=[ids])
    with pytest.raises(RuntimeError, match="quiesce"):
        a.check_invariants(quiesce=True)
    with pytest.raises(RuntimeError, match="mappings hold it"):
        a.check_invariants(mappings=[ids, ids[:1]])
    with pytest.raises(RuntimeError, match="leak"):
        a.check_invariants(mappings=[ids[:1]])
    a.release(ids)
    a.unreserve(1)
    with pytest.raises(RuntimeError, match="double free"):
        a.release(ids[:1])
    with pytest.raises(RuntimeError, match="exhausted"):
        tsv.BlockAllocator(3).alloc(3)


@pytest.mark.parametrize("kwargs, error, match", [
    (dict(spec_k=2, greedy=False), ValueError, "greedy-only"),
    (dict(draft_cfg=object()), ValueError, "without spec_k"),
    (dict(brownout=True), NotImplementedError, "A10"),
    (dict(chunk_size=0), ValueError, "chunk_size"),
    (dict(pipeline_depth=0), ValueError, "pipeline_depth"),
    (dict(greedy=True, top_k=3), ValueError, "greedy=True"),
    (dict(paged=True, block_size=7), ValueError, "block_size"),
])
def test_unported_batcher_options_raise(kwargs, error, match):
    """What is still refused or invalid: brownout names its ROADMAP
    item; speculative dispatch with sampling, a draft model without
    spec_k, a zero chunk or depth, greedy with a sampling control and a
    block size that does not divide max_len are invalid, with the JAX
    batcher's errors."""
    tcfg = ttf.TransformerConfig(**CFG)
    tp = ttf.init_params(tcfg, device="cpu")
    with pytest.raises(error, match=match):
        tsv.ContinuousBatcher(tp, tcfg, device="cpu", **kwargs)


@pytest.mark.parametrize("kwargs", [dict(priority=1), dict(key="k")])
def test_unported_admission_options_raise(kwargs):
    """Once refused, ``priority`` and ``key`` are admission options now:
    with free capacity a priority admission preempts nobody, and a key
    given twice admits once."""
    tcfg = ttf.TransformerConfig(**CFG)
    tp = ttf.init_params(tcfg, device="cpu")
    srv = tsv.ContinuousBatcher(tp, tcfg, device="cpu")
    rid = srv.admit([1, 2, 3], 2, **kwargs)
    again = srv.admit([1, 2, 3], 2, **kwargs)
    assert rid is not None and not srv.preempted
    assert srv.active_count == (1 if "key" in kwargs else 2)
    assert (again == rid) == ("key" in kwargs)


def test_cache_prefix_disabled_by_zero_slots():
    tcfg = ttf.TransformerConfig(**CFG)
    tp = ttf.init_params(tcfg, device="cpu")
    for paged in (False, True):
        srv = tsv.ContinuousBatcher(tp, tcfg, prefix_cache_slots=0,
                                    paged=paged, block_size=BS, device="cpu")
        with pytest.raises(ValueError, match="prefix_cache_slots=0"):
            srv.cache_prefix([1, 2, 3])


def test_batcher_needs_cuda_unless_told(monkeypatch):
    tcfg = ttf.TransformerConfig(**CFG)
    tp = ttf.init_params(tcfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsv.ContinuousBatcher(tp, tcfg)
