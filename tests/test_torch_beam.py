"""The port's ``beam_search`` held against the JAX package's on the CPU, at
the size of tests/test_torch_serving_dense.py (vocab 97, d_model 32, 4
heads over 2 KV heads, 2 layers, max_len 64, fp32): the same seeded
weights and prompts give the same beams, in the same order, and scores
within 1e-5 (log-probabilities summed over up to 12 tokens, each from
logits that agree to ~3e-7 between the packages); beam=1 is the port's
greedy ``generate()`` exactly; each token is one ``decode_step``.

Under an int8 KV cache a decode step re-quantises its probabilities to
int8 codes from statistics summed in another order, so a code on a
rounding edge may flip by one, which moves that step's logits by up to
the int8 serving tests' 1e-4 (tests/test_torch_kv_int8.py). A score sums
n_new steps' log-probabilities, so it is held at n_new x 1e-4 (1.2e-4
seen here on one batch row, its beams still JAX's; prefill caches agree
exactly).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu_torch import parallel
from mxnet_tpu_torch.models import transformer as ttf
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

jtf = importlib.import_module("mxnet_tpu.models.transformer")

CFG = dict(vocab_size=97, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=64, max_len=64)
V = CFG["vocab_size"]
TOL = 1e-5
TOL_INT8_STEP = 1e-4


def _models(**over):
    jcfg = jtf.TransformerConfig(**dict(CFG, **over))
    tcfg = ttf.TransformerConfig(**dict(CFG, **over))
    return (jcfg, jtf.init_params(jcfg, seed=5), tcfg,
            ttf.init_params(tcfg, seed=5, device="cpu"))


def _prompts(b, t, seed=1):
    return np.random.RandomState(seed).randint(0, V, (b, t)).astype(np.int32)


@pytest.mark.parametrize("beam, penalty, over", [
    (4, 0.0, {}),
    (4, 0.7, {}),
    (3, 0.0, dict(kv_cache_int8=True)),
    (2, 1.0, dict(use_flash_kernel=True, rope=True)),
])
def test_beams_match_jax(beam, penalty, over):
    """Batch 2: sequences equal JAX's beam for beam, scores within 1e-5,
    best first."""
    jcfg, jp, tcfg, tp = _models(**over)
    prompt = _prompts(2, 6)
    jseq, jsc = jtf.beam_search(jp, jnp.asarray(prompt), 10, jcfg, beam=beam,
                                length_penalty=penalty)
    seq, sc = ttf.beam_search(tp, prompt, 10, tcfg, beam=beam,
                              length_penalty=penalty, device="cpu")
    assert seq.shape == (2, beam, 16) and sc.shape == (2, beam)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
    tol = 10 * TOL_INT8_STEP if over.get("kv_cache_int8") else TOL
    np.testing.assert_allclose(sc.numpy(), np.asarray(jsc), rtol=0, atol=tol)
    assert (np.diff(sc.numpy(), axis=1) <= 0).all()
    assert (seq[:, :, :6].numpy() == prompt[:, None]).all()


@pytest.mark.parametrize("over", [{}, dict(kv_cache_int8=True)])
def test_beam_one_is_greedy_generate(over):
    _, _, tcfg, tp = _models(**over)
    prompt = _prompts(3, 5, seed=2)
    seq, _ = ttf.beam_search(tp, prompt, 12, tcfg, beam=1, device="cpu")
    want = ttf.generate(tp, prompt, 12, tcfg, device="cpu")
    assert seq[:, 0].tolist() == want.tolist()


def test_each_token_is_one_decode_step(monkeypatch):
    """The cache rides at B * beam: every step after the prefill is one
    decode_step of width B * beam at the token's position, so on the
    card the flash-decode kernel carries the search."""
    _, _, tcfg, tp = _models(use_flash_kernel=True)
    calls, lengths = [], []
    real_step, real_flash = ttf.decode_step, ttf.flash_decode

    def step(params, cache, tokens, pos, cfg, mesh=None):
        calls.append((tokens.shape[0], pos))
        return real_step(params, cache, tokens, pos, cfg, mesh)

    def flash(q, k, v, n):
        lengths.append(int(n))
        return real_flash(q, k, v, n)

    monkeypatch.setattr(ttf, "decode_step", step)
    monkeypatch.setattr(ttf, "flash_decode", flash)
    ttf.beam_search(tp, _prompts(2, 4), 6, tcfg, beam=3, device="cpu")
    assert calls == [(6, p) for p in range(4, 9)]
    assert lengths == [p + 1 for p in range(4, 9)
                       for _ in range(CFG["n_layers"])]


def test_beam_search_validation():
    _, _, tcfg, tp = _models()
    prompt = _prompts(1, 4)
    with pytest.raises(ValueError, match="max_len"):
        ttf.beam_search(tp, prompt, 61, tcfg, device="cpu")
    with pytest.raises(ValueError, match="n_new"):
        ttf.beam_search(tp, prompt, 0, tcfg, device="cpu")
    with pytest.raises(ValueError, match="beam width"):
        ttf.beam_search(tp, prompt, 4, tcfg, beam=0, device="cpu")
    with pytest.raises(ValueError, match="beam width"):
        ttf.beam_search(tp, prompt, 4, tcfg, beam=V + 1, device="cpu")
    # a mesh is taken (a world of one: the search itself)
    mesh = parallel.make_mesh({"dp": 1, "tp": 1}, device="cpu")
    seq, sc = ttf.beam_search(tp, prompt, 4, tcfg, mesh=mesh)
    want = ttf.beam_search(tp, prompt, 4, tcfg, device="cpu")
    assert torch.equal(seq, want[0]) and torch.equal(sc, want[1])
