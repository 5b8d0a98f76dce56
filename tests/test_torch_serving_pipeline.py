"""Chunked and pipelined dispatch of the port's batcher, dense and paged,
on the CPU at the size of tests/test_torch_serving.py, held against the
port itself (tests/test_torch_serving_dispatch.py holds four settings
against JAX): the whole grid of chunk sizes and depths gives the
unchunked streams, greedy and sampled with the port's own noise, and
those equal solo ``generate()``; pipelined admission and eviction with
chunks in flight, paged coverage, and a seeded churn against solo
``generate()``.
"""

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.models import serving as tsv
from mxnet_tpu_torch.models import transformer as ttf
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = dict(vocab_size=97, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=64, max_len=64)
V = CFG["vocab_size"]
BS = 8
SAMPLE = dict(temperature=0.8, top_k=30, top_p=0.9)
LAYOUTS = {"dense": dict(paged=False),
           "paged": dict(paged=True, block_size=BS)}


def _jobs(seed=12):
    """More requests than lanes, prompts of two bucket widths, streams
    crossing block edges, a budget past the chunk, seeds for sampling."""
    rng = np.random.RandomState(seed)
    return [([int(t) for t in rng.randint(0, V, n)], m, 100 + i)
            for i, (n, m) in enumerate(zip([3, 12, 5, 14, 1],
                                           [9, 4, 17, 6, 2]))]


@pytest.fixture(scope="module")
def models():
    tcfg = ttf.TransformerConfig(**CFG)
    return None, None, tcfg, ttf.init_params(tcfg, seed=11, device="cpu")


@pytest.fixture(scope="module")
def unchunked(models):
    """The port's (1, 1) streams per layout, greedy and sampled, in
    admission order: what every other chunk size and depth must give."""
    _, _, tcfg, tp = models
    out = {}
    for layout, kw in LAYOUTS.items():
        for sampled in (False, True):
            srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=3, device="cpu",
                                        **dict(kw, **(SAMPLE if sampled
                                                      else {})))
            res, order = srv.run(_jobs())
            out[layout, sampled] = [res[r] for r in order]
    return out


def _solo(tp, tcfg, prompt, n_new, **kw):
    return ttf.generate(tp, np.asarray([prompt]), n_new, tcfg, device="cpu",
                        **kw)[0].tolist()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("chunk", [1, 3, 4])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_grid_matches_unchunked(models, unchunked, layout, chunk, depth):
    """Every chunk size and depth gives the (1, 1) streams, greedy and
    sampled with the port's own noise (a request's draws do not depend on
    its lane, the chunk or the depth)."""
    _, _, tcfg, tp = models
    for sampled in (False, True):
        srv = tsv.ContinuousBatcher(
            tp, tcfg, max_batch=3, chunk_size=chunk, pipeline_depth=depth,
            device="cpu", **dict(LAYOUTS[layout],
                                 **(SAMPLE if sampled else {})))
        res, order = srv.run(_jobs())
        assert [res[r] for r in order] == unchunked[layout, sampled]
        srv.check_invariants(quiesce=True)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sampled_streams_equal_solo_generate(models, unchunked, layout):
    """A lane draws row 0 of its request's chain: each sampled stream is
    the request's solo generate(seed=...)."""
    _, _, tcfg, tp = models
    for (prompt, n_new, seed), got in zip(_jobs(),
                                          unchunked[layout, True]):
        assert got == _solo(tp, tcfg, prompt, n_new, seed=seed, **SAMPLE)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_pipelined_admission_enters_at_the_next_dispatch(models, layout):
    """A request admitted while chunks ride in flight is in no in-flight
    chunk's lane snapshot, and its stream (and the running one's) is the
    solo generate()."""
    _, _, tcfg, tp = models
    rng = np.random.RandomState(3)
    p1, p2 = ([int(t) for t in rng.randint(1, V, n)] for n in (6, 9))
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=2, pipeline_depth=3,
                                chunk_size=2, device="cpu",
                                **LAYOUTS[layout])
    r1 = srv.admit(p1, 10)
    done = srv.step()
    assert len(srv._inflight) == 2                 # one synced of three
    r2 = srv.admit(p2, 5)
    assert all(r2 not in lanes for _, _, lanes in srv._inflight)
    while r1 not in done or r2 not in done:
        done.update(srv.step())
    assert done[r1] == _solo(tp, tcfg, p1, 10)
    assert done[r2] == _solo(tp, tcfg, p2, 5)
    srv.check_invariants(quiesce=True)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_pipelined_cancel_mid_flight(models, layout):
    """cancel() with chunks in flight returns a prefix of the solo stream
    (synced so far), a new admission reuses the lane, and neither it nor
    the surviving lane sees the evicted request's in-flight tokens."""
    _, _, tcfg, tp = models
    rng = np.random.RandomState(7)
    p1, p2, p3 = ([int(t) for t in rng.randint(1, V, n)] for n in (5, 8, 4))
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=2, pipeline_depth=2,
                                device="cpu", **LAYOUTS[layout])
    r1, r2 = srv.admit(p1, 12), srv.admit(p2, 12)
    done = {}
    done.update(srv.step())
    done.update(srv.step())
    assert srv._inflight
    partial = srv.cancel(r1)
    assert partial == _solo(tp, tcfg, p1, 12)[:len(partial)]
    assert srv.cancel(r1) is None
    r3 = srv.admit(p3, 5)
    while r2 not in done or r3 not in done:
        done.update(srv.step())
    assert done[r2] == _solo(tp, tcfg, p2, 12)
    assert done[r3] == _solo(tp, tcfg, p3, 5)
    srv.check_invariants(quiesce=True)


def test_dispatch_count_and_paged_coverage(models):
    """dispatch_count counts one per chunk; before each paged dispatch
    every live lane's table covers all k positions the chunk writes
    within the request's lifetime (allocated from its reservation)."""
    _, _, tcfg, tp = models
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=2, chunk_size=5,
                                paged=True, block_size=BS, device="cpu")
    rid = srv.admit(list(range(1, 7)), 20)       # positions 6 .. 24
    steps = 0
    while srv.active_count:
        srv._ensure_coverage(srv.chunk_size)
        pos = int(srv._pos[0])
        last = min(pos + srv.chunk_size - 1, 6 + 20 - 2)
        assert len(srv._lane_blocks[0]) == last // BS + 1
        srv.check_invariants()
        out = srv.step()
        steps += 1
    assert srv.dispatch_count == steps == 4      # 19 decode tokens / 5
    assert len(out[rid]) == 26
    srv.check_invariants(quiesce=True)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_churn_matches_solo_generate(models, layout):
    """A seeded schedule of admits, cancels and steps on a chunked,
    pipelined pool: every completed stream is its solo generate(), every
    cancelled one a prefix of it, and the pool drains."""
    _, _, tcfg, tp = models
    rng = np.random.RandomState(10)
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=3, chunk_size=2,
                                pipeline_depth=3, device="cpu",
                                **LAYOUTS[layout])
    spec, done, cancelled, live = {}, {}, {}, []
    pending = [([int(t) for t in rng.randint(1, V, rng.randint(3, 20))],
                int(rng.randint(1, 12))) for _ in range(10)]
    while pending or live:
        action = rng.randint(0, 4)
        if action == 0 and pending and srv.has_capacity:
            prompt, n = pending.pop()
            rid = srv.admit(prompt, n)
            assert rid is not None
            spec[rid] = (prompt, n)
            live.append(rid)
        elif action == 1 and live and rng.rand() < 0.3:
            rid = live[rng.randint(len(live))]
            cancelled[rid] = srv.cancel(rid)
            live.remove(rid)
        else:
            for rid, toks in srv.step().items():
                done[rid] = toks
                live.remove(rid)
        srv.check_invariants()
    assert set(done) | set(cancelled) == set(spec) and cancelled
    for rid, (prompt, n) in spec.items():
        want = _solo(tp, tcfg, prompt, n)
        got = done.get(rid, cancelled.get(rid))
        assert got == want[:len(got)], "rid %d" % rid
        if rid in done:
            assert len(got) == len(want)
    srv.check_invariants(quiesce=True)


def test_pipelined_stream_with_stop_token(models):
    _, _, tcfg, tp = models
    prompt = [5, 9, 2]
    ref = _solo(tp, tcfg, prompt, 12)[len(prompt):]
    stop = ref[5]
    want = ref[:ref.index(stop) + 1]
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=2, chunk_size=4,
                                pipeline_depth=2, paged=True, block_size=BS,
                                device="cpu")
    events = list(srv.stream([(prompt, 12, 0, stop)]))
    assert [t for _, t, _ in events] == want
    assert [d for _, _, d in events] == [False] * (len(want) - 1) + [True]
    srv.check_invariants(quiesce=True)
