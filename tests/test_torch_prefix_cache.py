"""Prefix caching of the port's batcher (``cache_prefix``) on the CPU at
the size of tests/test_torch_serving.py: dense lanes keep an LRU of row
caches, paged lanes share refcounted pool blocks (nested prefixes share
their full blocks, a partial tail is copied on extend, an entry pinned by
a live lane is skipped by LRU eviction under block pressure). Cached
streams equal the uncached ones, solo ``generate()`` and the JAX
batcher's; the block accounting balances after every run.
"""

import importlib

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
BS = 8
SAMPLE = dict(temperature=0.7, top_k=13)
LAYOUTS = {"dense": dict(paged=False),
           "paged": dict(paged=True, block_size=BS)}
SYSTEM = [7, 3, 9, 1, 4, 8, 2, 6, 5, 11, 13]     # 11 tokens: a partial tail
JOBS = [(SYSTEM + [11, 22], 8, 1), ([5, 6], 6, 2), (SYSTEM + [33], 9, 3),
        (SYSTEM, 5, 4), (SYSTEM[:4] + [40, 41], 7, 5)]


@pytest.fixture(scope="module")
def models():
    jcfg = jtf.TransformerConfig(**CFG)
    tcfg = ttf.TransformerConfig(**CFG)
    return (jcfg, jtf.init_params(jcfg, seed=3), tcfg,
            ttf.init_params(tcfg, seed=3, device="cpu"))


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


def _solo(tp, tcfg, prompt, n_new, **kw):
    return ttf.generate(tp, np.asarray([prompt]), n_new, tcfg, device="cpu",
                        **kw)[0].tolist()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("sampled", [False, True])
def test_cached_streams_equal_uncached_and_jax(models, monkeypatch, layout,
                                               sampled):
    """With the prefix cached (mixed prefix and non-prefix prompts, an
    exact match, a shorter overlap that is no prefix), the streams are
    the uncached run's, each request's solo generate(), and the JAX
    batcher's with the same prefix cached (sampled: JAX's key chain
    replayed)."""
    jcfg, jp, tcfg, tp = models
    kw = dict(LAYOUTS[layout], **(SAMPLE if sampled else {}))
    jsrv = jsv.ContinuousBatcher(jp, jcfg, max_batch=2, **kw)
    jsrv.cache_prefix(SYSTEM)
    want, want_order = jsrv.run(JOBS)
    uncached, u_order = tsv.ContinuousBatcher(tp, tcfg, max_batch=2,
                                              device="cpu", **kw).run(JOBS)
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=2, device="cpu", **kw)
    assert srv.cache_prefix(SYSTEM) == len(SYSTEM)
    got, order = srv.run(JOBS)
    assert order == u_order == want_order
    assert got == uncached
    for rid, (prompt, n_new, seed) in zip(order, JOBS):
        solo_kw = dict(SAMPLE, seed=seed) if sampled else {}
        assert got[rid] == _solo(tp, tcfg, prompt, n_new, **solo_kw)
    srv.check_invariants(quiesce=True)
    if sampled:
        monkeypatch.setattr(ttf, "_gumbel", replayed_gumbel(1))
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=2, device="cpu", **kw)
    srv.cache_prefix(SYSTEM)
    assert srv.run(JOBS)[0] == want


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_pipelined_prefix_streams(models, layout):
    """Prefix-cached admissions, the exact match included, compose with
    chunked pipelined dispatch, greedy and sampled."""
    _, _, tcfg, tp = models
    for sampled in (False, True):
        kw = dict(LAYOUTS[layout], **(SAMPLE if sampled else {}))
        srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=2, chunk_size=3,
                                    pipeline_depth=2, device="cpu", **kw)
        srv.cache_prefix(SYSTEM)
        results, order = srv.run(JOBS)
        for rid, (prompt, n_new, seed) in zip(order, JOBS):
            solo_kw = dict(SAMPLE, seed=seed) if sampled else {}
            assert results[rid] == _solo(tp, tcfg, prompt, n_new, **solo_kw)
        srv.check_invariants(quiesce=True)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_lru_longest_match_and_validation(models, layout):
    _, _, tcfg, tp = models
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=2, prefix_cache_slots=2,
                                device="cpu", **LAYOUTS[layout])
    srv.cache_prefix([1, 2])
    srv.cache_prefix([3, 4])
    srv.cache_prefix([1, 2])          # refresh: [3, 4] is now the oldest
    srv.cache_prefix([5, 6])          # evicts [3, 4]
    assert set(srv._prefix_cache) == {(1, 2), (5, 6)}
    srv.check_invariants()
    srv.cache_prefix([1, 2])
    srv.cache_prefix([1, 2, 7, 8])    # nested in [1, 2]; evicts [5, 6]
    assert set(srv._prefix_cache) == {(1, 2), (1, 2, 7, 8)}
    assert srv._lookup_prefix([1, 2, 7, 8, 9])[0] == 4
    assert srv._lookup_prefix([1, 2, 9])[0] == 2
    assert srv._lookup_prefix([9, 1, 2])[0] == 0
    with pytest.raises(ValueError, match="empty"):
        srv.cache_prefix([])
    with pytest.raises(ValueError, match="max_len"):
        srv.cache_prefix(list(range(CFG["max_len"])))
    off = tsv.ContinuousBatcher(tp, tcfg, prefix_cache_slots=0,
                                device="cpu", **LAYOUTS[layout])
    with pytest.raises(ValueError, match="prefix_cache_slots=0"):
        off.cache_prefix([1])
    srv.check_invariants(quiesce=True)


def test_dense_prefix_row_is_not_written_by_admissions(models):
    """Prefill writes in place, so an admission extends a copy of the
    cached row: the entry stays the exact-length prefill (zeros past
    it) however many admissions read it."""
    _, _, tcfg, tp = models
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=2, device="cpu")
    srv.cache_prefix(SYSTEM)
    row, _ = srv._prefix_cache[tuple(SYSTEM)]
    before = [{n: leaf.clone() for n, leaf in layer.items()} for layer in row]
    srv.run([(SYSTEM + [1, 2, 3], 4), (SYSTEM + [9], 6)])
    for layer, old in zip(row, before):
        for name, leaf in layer.items():
            assert torch.equal(leaf, old[name])
            assert not leaf[0, len(SYSTEM):].any()


def test_paged_sharing_refcounts_nesting_and_copy_on_extend(models):
    """Nested cached prefixes share full blocks, longest first; an
    admission maps the full shared blocks (refcount up, nothing written
    to them) and copies the partial tail into its own block; a shared
    block frees only at refcount zero."""
    _, _, tcfg, tp = models
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=2, paged=True,
                                block_size=BS, device="cpu")
    usable = srv.num_blocks - 1
    base = list(range(1, 10))               # 9 tokens: 1 full + 1 partial
    srv.cache_prefix(base)
    assert srv._alloc.free_blocks == usable - 2
    longer = base + [11, 12, 13, 14, 15, 16, 17]      # 16 tokens
    srv.cache_prefix(longer)
    assert srv._alloc.free_blocks == usable - 3       # 1 shared + 1 own
    shared = srv._prefix_cache[tuple(base)][0][0]
    assert srv._prefix_cache[tuple(longer)][0][0] == shared
    assert int(srv._alloc.ref[shared]) == 2
    srv.check_invariants()
    saved = [{n: leaf[shared].clone() for n, leaf in layer.items()}
             for layer in srv._pool]
    prompt = longer + [21, 22]
    p_len, (blocks, _) = srv._lookup_prefix(prompt)
    assert p_len == 16 and blocks == srv._prefix_cache[tuple(longer)][0]
    rid = srv.admit(prompt, 5)
    assert srv._lane_blocks[0][:2] == blocks
    assert int(srv._alloc.ref[shared]) == 3
    # copy-on-extend: a 12-token prompt over `base` shares its full block
    # and copies its partial tail into a block of its own
    r2 = srv.admit(base + [30, 31, 32], 6)
    tail = srv._prefix_cache[tuple(base)][0][1]
    assert srv._lane_blocks[1][0] == shared
    assert srv._lane_blocks[1][1] != tail and int(srv._alloc.ref[tail]) == 1
    srv.check_invariants()
    out = {}
    while rid not in out or r2 not in out:
        out.update(srv.step())
        srv.check_invariants()
    assert out[rid] == _solo(tp, tcfg, prompt, 5)
    assert out[r2] == _solo(tp, tcfg, base + [30, 31, 32], 6)
    for layer, old in zip(srv._pool, saved):
        for name, leaf in layer.items():
            assert torch.equal(leaf[shared], old[name])
    assert int(srv._alloc.ref[shared]) == 2            # lanes released
    assert srv._evict_prefixes(srv.num_blocks) is False  # drains the cache
    assert not srv._prefix_cache and int(srv._alloc.ref[shared]) == 0
    assert srv._alloc.free_blocks == usable
    srv.check_invariants(quiesce=True)


def test_paged_lru_eviction_under_block_pressure(models):
    """Admission short of blocks LRU-evicts an unreferenced prefix and
    gets its blocks; an older entry pinned by a live lane is skipped, and
    a request the pool cannot cover waits (None)."""
    _, _, tcfg, tp = models
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=4, paged=True,
                                block_size=BS, num_blocks=7, device="cpu")
    a, b = list(range(1, 9)), list(range(21, 29))     # one full block each
    srv.cache_prefix(a)
    srv.cache_prefix(b)
    assert srv._alloc.free_blocks == 4
    ra = srv.admit(a + [31], 12)         # shares `a`'s block, 2 own
    assert ra is not None and srv._alloc.available == 2
    rid = srv.admit(list(range(41, 47)), 18)          # 3 blocks
    assert rid is not None
    assert tuple(b) not in srv._prefix_cache and tuple(a) in srv._prefix_cache
    assert srv.admit(list(range(50, 60)), 20) is None  # nothing evictable
    srv.check_invariants()
    done = {}
    while ra not in done or rid not in done:
        done.update(srv.step())
        srv.check_invariants()
    assert done[ra] == _solo(tp, tcfg, a + [31], 12)
    assert done[rid] == _solo(tp, tcfg, list(range(41, 47)), 18)
    assert srv._alloc.free_blocks == 5                 # all but `a`'s
    srv.check_invariants(quiesce=True)


def test_paged_pipelined_prefix_staleness_and_eviction(models):
    """The pipelined paged pool with a shared prefix: an admission mid
    flight, a cancel mid flight whose lane and blocks are reused, every
    stream exact."""
    _, _, tcfg, tp = models
    rng = np.random.RandomState(3)
    p1, p2, p3 = ([int(t) for t in rng.randint(1, V, n)] for n in (6, 9, 4))
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=2, paged=True,
                                block_size=BS, pipeline_depth=3,
                                device="cpu")
    srv.cache_prefix(SYSTEM)
    r1 = srv.admit(SYSTEM + p1, 10)
    done = srv.step()
    r2 = srv.admit(p2, 8)
    assert all(r2 not in lanes for _, _, lanes in srv._inflight)
    done.update(srv.step())
    partial = srv.cancel(r1)
    r3 = srv.admit(SYSTEM + p3, 5)
    while r2 not in done or r3 not in done:
        done.update(srv.step())
        srv.check_invariants()
    assert partial == _solo(tp, tcfg, SYSTEM + p1, 10)[:len(partial)]
    assert done[r2] == _solo(tp, tcfg, p2, 8)
    assert done[r3] == _solo(tp, tcfg, SYSTEM + p3, 5)
    srv.check_invariants(quiesce=True)
