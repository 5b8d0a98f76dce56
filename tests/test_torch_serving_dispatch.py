"""Chunked (``chunk_size``) and pipelined (``pipeline_depth``) dispatch of
the port's batcher, dense and paged, held against the JAX batcher's on
the CPU at the size of tests/test_torch_serving.py: greedy and sampled
streams equal JAX's at four (chunk, depth) settings (each JAX setting
compiles its own programs, so only these four; the port's whole grid is
in tests/test_torch_serving_pipeline.py).
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
SAMPLE = dict(temperature=0.8, top_k=30, top_p=0.9)
JAX_SETTINGS = [(1, 1), (3, 1), (4, 2), (3, 3)]          # (chunk, depth)
LAYOUTS = {"dense": dict(paged=False),
           "paged": dict(paged=True, block_size=BS)}


def _jobs(seed=12):
    """More requests than lanes, prompts of two bucket widths, streams
    crossing block edges, a budget past the chunk, seeds for sampling."""
    rng = np.random.RandomState(seed)
    return [([int(t) for t in rng.randint(0, V, n)], m, 100 + i)
            for i, (n, m) in enumerate(zip([3, 12, 5, 14, 1],
                                           [9, 4, 17, 6, 2]))]


# JAX's noise by (seed, token counter), shared by every sampled case
_NOISE = {}


def replayed_gumbel(batch):
    """``ttf._gumbel`` drawing JAX's noise (see tests/test_torch_sampling.py):
    token t of seed s uses the t-th sub-key of PRNGKey(s)."""
    cache = _NOISE.setdefault(batch, {})

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


@pytest.fixture(scope="module")
def models():
    jcfg = jtf.TransformerConfig(**CFG)
    tcfg = ttf.TransformerConfig(**CFG)
    return (jcfg, jtf.init_params(jcfg, seed=11), tcfg,
            ttf.init_params(tcfg, seed=11, device="cpu"))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("chunk, depth", JAX_SETTINGS)
@pytest.mark.parametrize("sampled", [False, True])
def test_streams_match_jax(models, monkeypatch, layout, chunk, depth,
                           sampled):
    """The JAX batcher's streams and admission order at the same chunk
    size and depth, token for token; sampled streams with JAX's key
    chain replayed. Every dispatch is one chunk, and the pool drains."""
    jcfg, jp, tcfg, tp = models
    kw = dict(LAYOUTS[layout], chunk_size=chunk, pipeline_depth=depth,
              **(SAMPLE if sampled else {}))
    want, want_order = jsv.ContinuousBatcher(jp, jcfg, max_batch=3,
                                             **kw).run(_jobs())
    if sampled:
        monkeypatch.setattr(ttf, "_gumbel", replayed_gumbel(1))
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=3, device="cpu", **kw)
    got, order = srv.run(_jobs())
    assert order == want_order and got == want
    srv.check_invariants(quiesce=True)
    if layout == "paged":
        assert srv.free_blocks == srv.num_blocks - 1
