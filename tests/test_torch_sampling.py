"""The port's sampler (``_sample_logits``), its counter-based noise
(``_gumbel``) and sampled ``generate()`` held against the JAX package on
the CPU, at the size of tests/test_torch_serving.py (vocab 97, d_model 32,
4 heads over 2 KV heads, 2 layers, max_len 64, fp32).

The port draws its own noise, so the JAX comparisons hand the port JAX's
own: ``jax.random.categorical`` is ``argmax(gumbel(key) + logits)``, and a
replayed ``_gumbel`` gives the port the Gumbel noise of JAX's key chain
(``key = PRNGKey(seed)``, then ``key, sub = split(key)`` per token).
"""

import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.models import transformer as ttf
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

jtf = importlib.import_module("mxnet_tpu.models.transformer")

CFG = dict(vocab_size=97, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=64, max_len=64)
V = CFG["vocab_size"]
# (temperature, top_k, top_p) of the sampler checks
CONTROLS = [(1.0, None, None), (0.7, None, None), (1.0, 5, None),
            (0.8, 20, 0.95), (1.3, None, 0.9), (0.5, 96, 0.5)]
# where the cumulative mass preceding a token lies this close to top_p,
# XLA's and torch's fp32 cumsums may round to opposite sides of it
BOUNDARY = 1e-6


def _models(seed):
    jcfg = jtf.TransformerConfig(**CFG)
    tcfg = ttf.TransformerConfig(**CFG)
    return (jcfg, jtf.init_params(jcfg, seed=seed), tcfg,
            ttf.init_params(tcfg, seed=seed, device="cpu"))


def replayed_gumbel(batch):
    """A stand-in for ``ttf._gumbel`` that draws JAX's noise: token t of
    seed s uses the t-th sub-key of PRNGKey(s), noise gumbel(sub, (batch,
    V)) and its row."""
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
        assert vocab == V
        return torch.from_numpy(np.stack([
            noise(s, c)[r] for s, c, r in zip(seeds.tolist(),
                                              counters.tolist(),
                                              rows.tolist())])).to(device)
    return gumbel


def _boundary_rows(logits, temperature, top_k, top_p):
    """Rows whose top-p cut may round either way (float64 reckoning)."""
    if top_p is None or top_p >= 1.0:
        return np.zeros(logits.shape[0], bool)
    x = logits.astype(np.float64) / max(temperature, 1e-6)
    if top_k is not None and 0 < top_k < x.shape[-1]:
        kth = np.sort(x, -1)[:, -top_k][:, None]
        x = np.where(x < kth, -np.inf, x)
    s = -np.sort(-x, -1)
    p = np.exp(s - s[:, :1])
    cum = np.cumsum(p / p.sum(-1, keepdims=True), -1)
    return (np.abs(cum[:, :-1] - top_p) < BOUNDARY).any(-1)


@pytest.mark.parametrize("temperature, top_k, top_p", CONTROLS)
def test_sample_logits_matches_jax_on_its_noise(temperature, top_k, top_p):
    """Given the Gumbel noise ``jax.random.categorical`` draws for a key,
    the port's sampler picks JAX's token in every row but those whose
    top-p cut sits within BOUNDARY of a cumulative sum (counted, not
    avoided)."""
    rng = np.random.RandomState(0)
    logits = (rng.randn(512, V) * 2).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jtf._sample_logits(jnp.asarray(logits), key,
                                         temperature, top_k, top_p))
    noise = np.array(jax.random.gumbel(key, logits.shape, jnp.float32))
    got = ttf._sample_logits(torch.from_numpy(logits),
                             torch.from_numpy(noise), temperature, top_k,
                             top_p)
    assert got.dtype == torch.int32 and got.shape == (512,)
    boundary = _boundary_rows(logits, temperature, top_k, top_p)
    differ = got.numpy() != want
    assert not (differ & ~boundary).any(), (
        "rows %s differ off the top-p boundary"
        % np.flatnonzero(differ & ~boundary)[:10])
    assert boundary.sum() <= 2, "%d boundary rows" % boundary.sum()


def test_top_k_keeps_ties_at_the_kth_value():
    """top-k masks only logits BELOW the kth value, so every token tied
    with it stays sampleable, as in JAX; held against JAX on rows full of
    ties too."""
    logits = torch.tensor([[3.0, 2.0, 2.0, 2.0, 1.0]])
    for winner in (1, 2, 3):
        noise = torch.zeros(1, 5)
        noise[0, winner] = 5.0
        assert ttf._sample_logits(logits, noise, 1.0, 2, None).item() \
            == winner
    noise = torch.zeros(1, 5)
    noise[0, 4] = 5.0                # below the kth value: masked
    assert ttf._sample_logits(logits, noise, 1.0, 2, None).item() == 0
    rng = np.random.RandomState(1)
    tied = rng.randint(0, 4, (256, V)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    want = np.asarray(jtf._sample_logits(jnp.asarray(tied), key, 1.0, 7,
                                         None))
    noise = np.array(jax.random.gumbel(key, tied.shape, jnp.float32))
    got = ttf._sample_logits(torch.from_numpy(tied), torch.from_numpy(noise),
                             1.0, 7, None)
    np.testing.assert_array_equal(got.numpy(), want)


def test_gumbel_is_a_pure_function_of_its_draw():
    """Each row's noise depends only on its own (seed, counter, row): the
    same draws give the same bits, in any order and beside any other
    rows; a different seed, counter or row gives different bits; the
    words are 32-bit; and the bits are pinned, since every sampled stream
    of the port depends on them."""
    seeds = torch.tensor([0, 1, -1, 2 ** 40 + 7])
    counters = torch.tensor([0, 0, 3, 5])
    rows = torch.tensor([0, 1, 0, 2])
    bits = ttf._gumbel_bits(seeds, counters, rows, 5, "cpu")
    assert bits.tolist() == [
        [3963942125, 1801633923, 1591981486, 2398419003, 3838861008],
        [749775205, 576184978, 2344813627, 2365898021, 2976743863],
        [743987460, 4157525898, 1768137361, 1994060556, 4103119389],
        [149050749, 3653548142, 2293227070, 2006307764, 4055021782]]
    perm = torch.tensor([2, 0, 3, 1])
    again = ttf._gumbel_bits(seeds[perm], counters[perm], rows[perm], 5,
                             "cpu")
    assert torch.equal(again, bits[perm])
    alone = ttf._gumbel(seeds[2:3], counters[2:3], rows[2:3], V, "cpu")
    both = ttf._gumbel(seeds, counters, rows, V, "cpu")
    assert torch.equal(alone[0], both[2])
    for s, c, r in ((0, 0, 1), (0, 1, 0), (1, 0, 0)):
        other = ttf._gumbel_bits(torch.tensor([s]), torch.tensor([c]),
                                 torch.tensor([r]), 5, "cpu")
        assert not torch.equal(other[0], bits[0])
    wide = ttf._gumbel_bits(torch.arange(64), torch.arange(64) % 7,
                            torch.zeros(64, dtype=torch.long), 4096, "cpu")
    assert int(wide.min()) >= 0 and int(wide.max()) < 2 ** 32
    assert wide.unique().numel() > 0.99 * wide.numel()


def test_gumbel_noise_is_standard_gumbel():
    """Over 2^20 draws the noise has the standard Gumbel's mean (Euler's
    constant) and standard deviation (pi / sqrt(6)) to 0.01, and is
    finite: u never reaches 0 or 1."""
    g = ttf._gumbel(torch.arange(256), torch.zeros(256, dtype=torch.long),
                    torch.zeros(256, dtype=torch.long), 4096, "cpu")
    assert torch.isfinite(g).all()
    assert abs(float(g.mean()) - 0.5772157) < 0.01
    assert abs(float(g.std()) - np.pi / np.sqrt(6)) < 0.01


@pytest.mark.parametrize("kwargs", [
    dict(temperature=0.8, top_k=20),
    dict(greedy=False),
    dict(temperature=1.3, top_p=0.9),
    dict(temperature=0.6, top_k=30, top_p=0.95),
])
def test_generate_samples_jax_stream_on_its_noise(monkeypatch, kwargs):
    """Sampled generate() over a batch of 3 gives JAX's tokens when fed
    JAX's key chain (row b of token t's noise drawn at batch 3)."""
    jcfg, jp, tcfg, tp = _models(5)
    prompt = np.random.RandomState(3).randint(0, V, (3, 6)).astype(np.int32)
    want = np.asarray(jtf.generate(jp, jnp.asarray(prompt), 10, jcfg,
                                   seed=5, **kwargs))
    monkeypatch.setattr(ttf, "_gumbel", replayed_gumbel(3))
    got = ttf.generate(tp, prompt, 10, tcfg, seed=5, device="cpu", **kwargs)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_greedy_rule():
    """generate()'s rule, as the JAX package's: no control means greedy
    (temperature 1.0 alone included), greedy=False alone samples at
    temperature 1, greedy=True with a control raises; a sampled stream
    is a function of its seed."""
    _, _, tcfg, tp = _models(6)
    prompt = np.random.RandomState(4).randint(0, V, (2, 5)).astype(np.int32)
    greedy = ttf.generate(tp, prompt, 8, tcfg, device="cpu")
    assert torch.equal(ttf.generate(tp, prompt, 8, tcfg, temperature=1.0,
                                    seed=9, device="cpu"), greedy)
    assert torch.equal(ttf.generate(tp, prompt, 8, tcfg, greedy=True,
                                    seed=9, device="cpu"), greedy)
    a = ttf.generate(tp, prompt, 8, tcfg, greedy=False, seed=1,
                     device="cpu")
    assert torch.equal(ttf.generate(tp, prompt, 8, tcfg, greedy=False,
                                    seed=1, device="cpu"), a)
    assert not torch.equal(ttf.generate(tp, prompt, 8, tcfg, greedy=False,
                                        seed=2, device="cpu"), a)
    assert not torch.equal(a, greedy)
    # at a vanishing temperature sampling is the argmax
    assert torch.equal(ttf.generate(tp, prompt, 8, tcfg, temperature=1e-6,
                                    seed=3, device="cpu"), greedy)
    for controls in (dict(top_k=3), dict(top_p=0.5), dict(temperature=0.7)):
        with pytest.raises(ValueError, match="greedy=True"):
            ttf.generate(tp, prompt, 2, tcfg, greedy=True, device="cpu",
                         **controls)


def test_generate_row_is_its_own_chain():
    """Row b of a sampled batch draws row b of its seed's chain: the
    batch's first row equals the same prompt generated alone."""
    _, _, tcfg, tp = _models(8)
    prompt = np.random.RandomState(5).randint(0, V, (3, 7)).astype(np.int32)
    batch = ttf.generate(tp, prompt, 9, tcfg, seed=4, temperature=0.9,
                         device="cpu")
    alone = ttf.generate(tp, prompt[:1], 9, tcfg, seed=4, temperature=0.9,
                         device="cpu")
    assert torch.equal(batch[:1], alone)
    assert list(inspect.signature(ttf._gumbel).parameters) == [
        "seeds", "counters", "rows", "vocab", "device"]
