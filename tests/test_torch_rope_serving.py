"""The port's serving paths on a RoPE model held against the JAX package,
on the CPU, at a small size (vocab 97, d_model 64, 4 heads of 16 over 2
KV heads, 2 layers, d_ff 64, max_len 64, 8-position blocks, fp32,
``rope=True``: no position table, q and k rotated, keys cached rotated).

The same seeded numpy inputs go through both packages, the JAX side
jitted. With ``use_flash_kernel`` the JAX package runs its flash-decode
Pallas kernel in interpret mode and the port the kernel's plain version
(CPU tensors), which the GPU kernels are held against by
``chip_smoke.py``.

Tolerances: logits and float caches at atol 1e-4, as the fp32 serving
tests hold them (the same products summed in another order; RoPE's
frequencies come from torch's and XLA's own ``pow``, 1-2 ulps apart,
which moves an angle below position 64 by under 1e-5 of a radian);
greedy streams agree exactly.
"""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu_torch.models import convert
from mxnet_tpu_torch.models import serving as tsv
from mxnet_tpu_torch.models import transformer as ttf
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

jtf = importlib.import_module("mxnet_tpu.models.transformer")
jsv = importlib.import_module("mxnet_tpu.models.serving")

CFG = dict(vocab_size=97, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=64, max_len=64, rope=True)
BS = 8
ATOL = 1e-4


def _models(seed, **over):
    kw = dict(CFG, **over)
    jcfg, tcfg = jtf.TransformerConfig(**kw), ttf.TransformerConfig(**kw)
    return (jcfg, jtf.init_params(jcfg, seed=seed), tcfg,
            ttf.init_params(tcfg, seed=seed, device="cpu"))


def _jit(fn, cfg, **kw):
    """``fn(*args, cfg, **kw)`` of the JAX package, jitted over args."""
    return jax.jit(lambda *args: fn(*args, cfg, **kw))


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, what):
    if isinstance(got, list):
        for i, (a, b) in enumerate(zip(got, want)):
            assert set(a) == set(b) == {"k", "v"}
            for name in a:
                _close(a[name], b[name], "%s layer %d %s" % (what, i, name))
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=ATOL, err_msg=what)


def test_rope_model_has_no_position_table_and_rotates_at_each_position():
    """The serving model carries no ``pos`` table; the port's _rope agrees
    with the JAX package's at [T] positions on [B, T, H, D], and at a
    scalar and at [B] positions on [B, H, D], as decode calls it."""
    _, jp, _, tp = _models(0)
    assert "pos" not in jp and not hasattr(tp, "pos")
    rng = np.random.RandomState(0)
    x = rng.randn(3, 7, 4, 16).astype(np.float32)
    _close(ttf._rope(_t(x), torch.arange(7), 1e4),
           jtf._rope(jnp.asarray(x), jnp.arange(7), 1e4), "[T] positions")
    for pos in (5, np.array([0, 9, 63], np.int32)):
        got = ttf._rope(_t(x[:, 0]), _t(pos) if np.ndim(pos) else pos, 1e4)
        _close(got, jtf._rope(jnp.asarray(x[:, 0]), jnp.asarray(pos), 1e4),
               "positions %s" % (pos,))


@pytest.mark.parametrize("flash", [False, True])
def test_prefill_and_prefill_chunk_match_jax(flash):
    """Logits and rotated caches of prefill (the flash forward kernel's
    plain version under use_flash_kernel) and of a chunk continuing it at
    position 11."""
    jcfg, jp, tcfg, tp = _models(1, use_flash_kernel=flash)
    toks = np.random.RandomState(0).randint(0, 97, (2, 11)).astype(np.int32)
    jl, jc = jtf._jitted_prefill(jcfg)(jp, jtf.init_cache(jcfg, 2),
                                       jnp.asarray(toks))
    tl, tc = ttf.prefill(tp, ttf.init_cache(tcfg, 2, "cpu"), _t(toks), tcfg)
    _close(tl, jl, "prefill logits")
    _close(tc, jc, "prefill cache")
    more = np.random.RandomState(1).randint(0, 97, (2, 5)).astype(np.int32)
    jl2, jc = jtf._jitted_prefill_chunk(jcfg)(jp, jc, jnp.asarray(more), 11)
    tl2, tc = ttf.prefill_chunk(tp, tc, _t(more), 11, tcfg)
    _close(tl2, jl2, "prefill_chunk logits")
    _close(tc, jc, "prefill_chunk cache")


@pytest.mark.parametrize("flash", [False, True])
def test_decode_step_matches_jax(flash):
    """A scalar step, then a ragged one with rows at their own positions
    (one rewinding): q and the new key rotate at each row's position, and
    attention reads the rotated cache — through flash decode with
    use_flash_kernel."""
    jcfg, jp, tcfg, tp = _models(2, use_flash_kernel=flash)
    rng = np.random.RandomState(2)
    toks = rng.randint(0, 97, (3, 9)).astype(np.int32)
    _, jc = jtf._jitted_prefill(jcfg)(jp, jtf.init_cache(jcfg, 3),
                                      jnp.asarray(toks))
    _, tc = ttf.prefill(tp, ttf.init_cache(tcfg, 3, "cpu"), _t(toks), tcfg)
    tok = rng.randint(0, 97, 3).astype(np.int32)
    step = jtf._jitted_decode_step(jcfg)
    jl, jc = step(jp, jc, jnp.asarray(tok), jnp.int32(9))
    tl, tc = ttf.decode_step(tp, tc, _t(tok), 9, tcfg)
    _close(tl, jl, "decode_step logits")
    pos = np.array([10, 4, 9], np.int32)
    jl, jc = step(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
    tl, tc = ttf.decode_step(tp, tc, _t(tok), _t(pos), tcfg)
    _close(tl, jl, "ragged decode_step logits")
    _close(tc, jc, "decode cache")


def test_decode_step_paged_matches_jax():
    """Three steps through pools filled alike with random rows, lane 0
    parked on the null table: logits, and the pools after the lanes'
    rotated writes."""
    jcfg, jp, tcfg, tp = _models(4)
    rng = np.random.RandomState(4)
    nb, lanes = CFG["max_len"] // BS, 3
    tables = np.zeros((lanes, nb), np.int32)
    for i in range(1, lanes):
        tables[i] = 1 + (i - 1) * nb + rng.permutation(nb)
    pos = np.array([0, 13, 40], np.int32)
    tok = rng.randint(0, 97, lanes).astype(np.int32)
    jpool = [{n: jnp.asarray(rng.randn(*a.shape).astype(np.float32))
              for n, a in layer.items()}
             for layer in jtf.init_paged_cache(jcfg, 1 + (lanes - 1) * nb,
                                               BS)]
    tpool = convert.cache_from_jax(jax.tree.map(np.asarray, jpool), "cpu")
    jstep = _jit(jtf.decode_step_paged, jcfg)
    for step in range(3):
        p = pos + step
        jl, jpool = jstep(jp, jpool, jnp.asarray(tables), jnp.asarray(tok),
                          jnp.asarray(p))
        tl, tpool = ttf.decode_step_paged(tp, tpool, _t(tables), _t(tok),
                                          _t(p), tcfg)
        _close(tl, jl, "paged logits, step %d" % step)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    _close(tpool, jpool, "pool")


def test_generate_and_batcher_streams_match_jax():
    """With use_flash_kernel (flash prefill and flash decode in
    generate(); the paged kernel in the batcher): the port's generate()
    equals JAX's, and the port's batcher (3 lanes, more requests than
    lanes, streams crossing block edges) gives each request its solo
    generate() stream and JAX's batcher's stream."""
    jcfg, jp, tcfg, tp = _models(11, use_flash_kernel=True)
    rng = np.random.RandomState(12)
    jobs = [([int(t) for t in rng.randint(0, 97, n)], m)
            for n, m in zip([3, 12, 5, 14], [9, 4, 17, 6])]
    prompt = np.asarray([jobs[1][0]], np.int32)
    want = np.asarray(jtf.generate(jp, jnp.asarray(prompt), 10, jcfg))
    got = ttf.generate(tp, prompt, 10, tcfg, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    jout, jorder = jsv.ContinuousBatcher(jp, jcfg, max_batch=3, paged=True,
                                         block_size=BS).run(jobs)
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=3, paged=True,
                                block_size=BS, device="cpu")
    out, order = srv.run(jobs)
    assert order == jorder and out == jout
    for rid, (p, n_new) in zip(order, jobs):
        solo = ttf.generate(tp, np.asarray([p]), n_new, tcfg, device="cpu")
        assert out[rid] == solo[0].tolist()
    srv.check_invariants(quiesce=True)
