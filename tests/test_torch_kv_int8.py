"""The port's int8 KV caches held against the JAX package, on the CPU, at
a small size (vocab 97, d_model 64, 4 heads of 16 over 2 KV heads, 2
layers, d_ff 64, max_len 64, 8-position blocks, fp32).

The same seeded numpy inputs go through both packages. The JAX package's
Pallas paged kernel runs in interpret mode, as ``tests/test_paged_kernel.py``
runs it; on CPU tensors the port runs the kernel's plain version, which
the GPU kernel is held against by ``chip_smoke.py``.

The JAX side runs jitted (its own serving jit cache where it has one):
eager JAX compiles every op on first use, which would make these tests
several times slower.

Tolerances. Quantisation codes are compared bitwise and their scales
within one fp32 ulp where both packages quantise the same numbers. In
the model, K and V rows come out of matmuls that sum in another order
(about 1e-7 apart), so scales agree to rtol 1e-5 and a code may flip by
one where a row sits on a rounding edge: codes may differ by at most 1,
in at most 1% of the elements. Logits agree at atol 1e-4, as the fp32
serving tests hold them; greedy streams agree exactly.
"""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.kernels import paged_attention as jax_paged_attention
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.kernels import common
from mxnet_tpu_torch.models import convert
from mxnet_tpu_torch.models import serving as tsv
from mxnet_tpu_torch.models import transformer as ttf
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

jtf = importlib.import_module("mxnet_tpu.models.transformer")
jsv = importlib.import_module("mxnet_tpu.models.serving")

CFG = dict(vocab_size=97, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=64, max_len=64, kv_cache_int8=True)
# int8 KV alone, and with RoPE
VARIANTS = {"int8": {}, "int8_rope": {"rope": True}}
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


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, what):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=ATOL,
                               err_msg=what)


def _same_cache(got, want, what):
    """Per-layer caches or pools: float leaves at atol 1e-4, scale planes
    at rtol 1e-5, codes within one step in at most 1% of the elements."""
    for i, (a, b) in enumerate(zip(got, want)):
        assert set(a) == set(b), what
        for name in a:
            x, y = _np(a[name]), np.asarray(b[name])
            where = "%s layer %d %s" % (what, i, name)
            assert x.dtype == y.dtype and x.shape == y.shape, where
            if x.dtype == np.int8:
                diff = np.abs(x.astype(np.int32) - y.astype(np.int32))
                assert diff.max() <= 1 and diff.mean() <= 0.01, where
            elif name in ("ks", "vs"):
                np.testing.assert_allclose(x, y, rtol=1e-5, atol=0,
                                           err_msg=where)
            else:
                np.testing.assert_allclose(x, y, rtol=0, atol=ATOL,
                                           err_msg=where)


# ------------------------------------------------------- quantisation ---

def test_kv_quant_matches_jax_bitwise_including_ties():
    """Codes bitwise, round half to even on exact .5 ties (a row whose
    max is 127 has scale 1, so 2.5 -> 2, -0.5 -> -0, 3.5 -> 4); scales
    within one fp32 ulp; an all-zero row takes the 1e-8 floor; the
    dequantised rows agree bitwise."""
    rng = np.random.RandomState(0)
    x = (rng.randn(6, 5, 16) * 3).astype(np.float32)
    x[0, 0] = [127, 2.5, -0.5, 3.5, -126.5, 0.5, 1.5, -2.5] * 2
    x[0, 1] = 0.0
    x8, xs = common.kv_quant(_t(x))
    j8, js = jtf._kv_quant(jnp.asarray(x))
    assert x8.dtype == torch.int8 and xs.dtype == torch.float32
    np.testing.assert_array_equal(x8.numpy(), np.asarray(j8))
    assert x8[0, 0, :8].tolist() == [127, 2, 0, 4, -126, 0, 2, -2]
    assert xs[0, 1] == np.float32(1e-8) / np.float32(127)
    np.testing.assert_array_max_ulp(xs.numpy(), np.asarray(js), maxulp=1)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        got = ttf._kv_dequant(x8, xs, dtype).float().numpy()
        want = np.asarray(jtf._kv_dequant(j8, js, jdtype).astype(jnp.float32))
        np.testing.assert_array_equal(got, want)
    # bf16 input quantises from its fp32 value
    xb = _t(x).bfloat16()
    np.testing.assert_array_equal(
        ttf._kv_quant(xb)[0].numpy(),
        np.asarray(jtf._kv_quant(jnp.asarray(x, jnp.bfloat16))[0]))


# ------------------------------------------------- paged kernel, int8 ---

def _int8_paged_setup(rng, span, g, dtype, b=3, kvh=2, d=16, bs=8, nb=4):
    """An int8 pool quantised from seeded rows (by the JAX quantiser),
    permuted per-lane tables with null-block tails and ragged positions:
    a partial last block, and a lane ending at the table's capacity."""
    nblocks = 1 + b * nb
    pool = {}
    for name in ("k", "v"):
        codes, scales = jtf._kv_quant(jnp.asarray(
            rng.randn(nblocks, bs, kvh, d).astype(np.float32)))
        pool[name], pool[name + "s"] = np.asarray(codes), np.asarray(scales)
    pos = np.array([3, 13, nb * bs - span])[:b].astype(np.int32)
    tables = np.zeros((b, nb), np.int32)
    for i in range(b):
        need = -(-(pos[i] + span) // bs)
        tables[i, :need] = 1 + i * nb + rng.permutation(nb)[:need]
    q = rng.randn(b, span, kvh * g, d).astype(np.float32)
    return jnp.asarray(q, dtype), pool, tables, pos


@jax.jit
def _jax_dense_ref(q, pool, tables, pos):
    """The JAX package's gather path: _paged_gather through the tables,
    the `<= pos + c` mask, _int8_cache_attention (the op sequence of
    tests/test_paged_kernel.py's _dense_ref)."""
    b, span, h, d = q.shape
    kvh = pool["k"].shape[2]
    att = jtf._paged_gather(pool, tables)
    t_pos = jnp.arange(att["k"].shape[1])
    positions = pos[:, None] + jnp.arange(span)[None, :]
    mask = t_pos[None, None, :] <= positions[:, :, None]
    o = jtf._int8_cache_attention(q.reshape(b, span, kvh, h // kvh, d), att,
                                  mask, q.dtype)
    return o.reshape(b, span, h, d)


@pytest.mark.parametrize("span", [1, 2, 5])
@pytest.mark.parametrize("g", [1, 4])
def test_int8_paged_attention_matches_jax_kernel_and_dense_ref(span, g):
    """The plain version the CPU runs against the JAX package's Pallas
    kernel (interpret mode) and its dense gather reference, at the JAX
    test's own bars: fp32 1e-5, bf16 3e-2. The wrapper on CPU tensors is
    the plain version, bit for bit. The JAX kernel runs with one grid
    step over the whole table (block_k = capacity): any legal block_k
    gives its numbers (tests/test_paged_kernel.py), and interpret mode
    runs each grid step in Python."""
    rng = np.random.RandomState(span * 16 + g)
    for dtype, jdtype, tol in ((torch.float32, jnp.float32, 1e-5),
                               (torch.bfloat16, jnp.bfloat16, 3e-2)):
        q, pool, tables, pos = _int8_paged_setup(rng, span, g, jdtype)
        tq = _t(np.asarray(q.astype(jnp.float32))).to(dtype)
        tpool = {n: _t(a) for n, a in pool.items()}
        got = kernels.paged_attention_reference(tq, tpool, _t(tables),
                                                _t(pos))
        assert got.dtype == dtype and got.shape == tq.shape
        jpool = {n: jnp.asarray(a) for n, a in pool.items()}
        jt, jpos = jnp.asarray(tables), jnp.asarray(pos)
        for want in (jax_paged_attention(q, jpool, jt, jpos,
                                         block_k=tables.size // len(pos) * 8,
                                         interpret=True),
                     _jax_dense_ref(q, jpool, jt, jpos)):
            want = np.asarray(want.astype(jnp.float32))
            np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                       atol=tol)
        wrapped = kernels.paged_attention(tq, tpool, _t(tables), _t(pos))
        np.testing.assert_array_equal(wrapped.float().numpy(),
                                      got.float().numpy())


def test_int8_contraction_is_exact_for_saturated_codes_at_t2048():
    """T = 2048 positions of saturated K codes and V codes in [100, 127]
    with unit scales: the softmax is flat and exact (a = 1/2048), every
    probability code is 127, and the PV sums (~2.9e7) pass 2^24, where
    fp32 can no longer add an odd integer exactly. The output must be the
    numpy int64 sum times the probability scale, bit for bit; the same
    contraction accumulated in fp32 is shown to miss it."""
    t, kvh, d = 2048, 1, 16
    rng = np.random.RandomState(5)
    vq = rng.randint(100, 128, (1, t, kvh, d)).astype(np.int8)
    cache = {"k": _t(np.full((1, t, kvh, d), 127, np.int8)),
             "ks": torch.ones(1, t, kvh), "v": _t(vq),
             "vs": torch.ones(1, t, kvh)}
    qg = torch.full((1, 1, kvh, 1, d), 0.5)
    mask = torch.ones(1, 1, t, dtype=torch.bool)
    got = common.int8_cache_attention(qg, cache, mask, torch.float32)
    as_ = np.float32(1 / t) / np.float32(127)
    assert np.round(np.float32(1 / t) / as_) == 127
    exact = 127 * vq.astype(np.int64).sum(axis=1)          # [1, KVH, D]
    assert exact.min() > 2 ** 24
    want = exact.astype(np.float32) * as_
    np.testing.assert_array_equal(got.reshape(-1).numpy(), want.reshape(-1))
    fp32_sum = torch.einsum("t,td->d", torch.full((t,), 127.0),
                            _t(vq[0, :, 0]).float())
    assert not np.array_equal(fp32_sum.numpy().astype(np.int64),
                              exact.reshape(-1))


# --------------------------------------------------------- the model ---

@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_prefill_and_prefill_chunk_match_jax(variant):
    """Logits and caches of prefill (which under int8 is prefill_chunk at
    start 0) and of a chunk continuing it, all rows and one row."""
    jcfg, jp, tcfg, tp = _models(1, **VARIANTS[variant])
    toks = np.random.RandomState(0).randint(0, 97, (2, 11)).astype(np.int32)
    jl, jc = jtf._jitted_prefill(jcfg)(jp, jtf.init_cache(jcfg, 2),
                                       jnp.asarray(toks))
    tl, tc = ttf.prefill(tp, ttf.init_cache(tcfg, 2, "cpu"), _t(toks), tcfg)
    _close(tl, jl, "prefill logits")
    _same_cache(tc, jc, "prefill cache")
    more = np.random.RandomState(1).randint(0, 97, (2, 5)).astype(np.int32)
    jl2, jc = jtf._jitted_prefill_chunk(jcfg)(jp, jc, jnp.asarray(more), 11)
    tl2, tc = ttf.prefill_chunk(tp, tc, _t(more), 11, tcfg)
    _close(tl2, jl2, "prefill_chunk logits")
    _same_cache(tc, jc, "prefill_chunk cache")
    jl3, _ = _jit(jtf.prefill_chunk, jcfg, logits_row=3, attend_limit=16)(
        jp, jc, jnp.asarray(more), 11)
    tl3, _ = ttf.prefill_chunk(tp, tc, _t(more), 11, tcfg, logits_row=3,
                               attend_limit=16)
    _close(tl3, jl3, "prefill_chunk logits_row")


def test_prefill_is_prefill_chunk_under_int8():
    """prefill delegates to prefill_chunk(start 0, logits_row Tp-1,
    attend_limit Tp): the same logits and caches, bit for bit."""
    _, _, tcfg, tp = _models(2)
    toks = _t(np.random.RandomState(2).randint(0, 97, (2, 9)))
    a, ca = ttf.prefill(tp, ttf.init_cache(tcfg, 2, "cpu"), toks, tcfg)
    b, cb = ttf.prefill_chunk(tp, ttf.init_cache(tcfg, 2, "cpu"), toks, 0,
                              tcfg, logits_row=8, attend_limit=9)
    assert torch.equal(a, b)
    for la, lb in zip(ca, cb):
        assert all(torch.equal(la[n], lb[n]) for n in ("k", "ks", "v", "vs"))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_step_matches_jax(variant):
    """A scalar step then a ragged one (rows at their own positions, one
    of them rewinding), with use_flash_kernel set: int8 takes the int8
    contraction first, as the JAX package does."""
    jcfg, jp, tcfg, tp = _models(3, use_flash_kernel=True,
                                 **VARIANTS[variant])
    rng = np.random.RandomState(3)
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
    _same_cache(tc, jc, "decode cache")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decode_step_paged_matches_jax(variant):
    """Three steps through int8 pools filled alike with random codes and
    scales: logits, and the pools (codes and scale planes) after the
    lanes' writes. Lane 0 is parked on the null table."""
    jcfg, jp, tcfg, tp = _models(4, **VARIANTS[variant])
    rng = np.random.RandomState(4)
    nb, lanes = CFG["max_len"] // BS, 3
    tables = np.zeros((lanes, nb), np.int32)
    for i in range(1, lanes):
        tables[i] = 1 + (i - 1) * nb + rng.permutation(nb)
    pos = np.array([0, 13, 40], np.int32)
    tok = rng.randint(0, 97, lanes).astype(np.int32)
    nblocks = 1 + (lanes - 1) * nb
    jpool = jtf.init_paged_cache(jcfg, nblocks, BS)
    for layer in jpool:
        for name in ("k", "v"):
            codes, scales = jtf._kv_quant(jnp.asarray(
                rng.randn(*layer[name].shape).astype(np.float32)))
            layer[name], layer[name + "s"] = codes, scales
    tpool = convert.cache_from_jax(jax.tree.map(np.asarray, jpool), "cpu")
    jt, tt = jnp.asarray(tables), _t(tables)
    jstep = _jit(jtf.decode_step_paged, jcfg)
    for step in range(3):
        p = pos + step
        jl, jpool = jstep(jp, jpool, jt, jnp.asarray(tok), jnp.asarray(p))
        tl, tpool = ttf.decode_step_paged(tp, tpool, tt, _t(tok), _t(p), tcfg)
        _close(tl, jl, "paged logits, step %d" % step)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    _same_cache(tpool, jpool, "pool")


def test_int8_pool_geometry_and_cache_round_trip():
    """init_paged_cache / init_cache leaves, dtypes and shapes as the JAX
    package's; paged_cache_nbytes by the JAX formula and equal to the
    bytes allocated; cache_from_jax / cache_to_numpy carry a JAX pool
    across and back bit for bit."""
    jcfg, _, tcfg, _ = _models(0)
    pool = ttf.init_paged_cache(tcfg, 9, BS, "cpu")
    jpool = jtf.init_paged_cache(jcfg, 9, BS)
    for got, want in ((pool, jpool),
                      (ttf.init_cache(tcfg, 2, "cpu"), jtf.init_cache(jcfg, 2))):
        assert [sorted(l) for l in got] == [sorted(l) for l in want]
        for a, b in zip(got, want):
            for name in a:
                assert tuple(a[name].shape) == b[name].shape
                assert str(a[name].dtype).split(".")[1] == str(b[name].dtype)
    nbytes = ttf.paged_cache_nbytes(tcfg, 9, BS)
    assert nbytes == jtf.paged_cache_nbytes(jcfg, 9, BS) == \
        sum(t.nbytes for layer in pool for t in layer.values())
    assert nbytes < ttf.paged_cache_nbytes(
        ttf.TransformerConfig(**dict(CFG, kv_cache_int8=False)), 9, BS)
    rng = np.random.RandomState(0)
    src = [{"k": rng.randint(-127, 128, (9, BS, 2, 16)).astype(np.int8),
            "ks": rng.rand(9, BS, 2).astype(np.float32),
            "v": rng.randint(-127, 128, (9, BS, 2, 16)).astype(np.int8),
            "vs": rng.rand(9, BS, 2).astype(np.float32)}]
    back = convert.cache_to_numpy(convert.cache_from_jax(src, "cpu"))
    for name, arr in src[0].items():
        assert back[0][name].dtype == arr.dtype
        np.testing.assert_array_equal(back[0][name], arr)
    with pytest.raises(ValueError, match="ks, vs"):
        convert.cache_from_jax([{"k": src[0]["k"], "ks": src[0]["ks"]}],
                               "cpu")


# -------------------------------------------------- streams and lanes ---

def _jobs(seed):
    rng = np.random.RandomState(seed)
    return [([int(t) for t in rng.randint(0, 97, n)], m)
            for n, m in zip([3, 12, 5, 14], [9, 4, 17, 6])]


def test_generate_and_batcher_streams_match_jax():
    """Greedy streams: the port's generate() equals JAX's, and the port's
    batcher (3 lanes, more requests than lanes, streams crossing block
    edges) gives each request its solo generate() stream and JAX's
    batcher's stream."""
    jcfg, jp, tcfg, tp = _models(11)
    jobs = _jobs(12)
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


def test_admission_writes_scale_rows_in_whole_blocks():
    """Admission copies the prefilled [1, T, KVH] scale rows into whole
    pool blocks beside their codes: each block the lane owns holds its
    bs positions of every leaf of the row cache."""
    _, _, tcfg, tp = _models(6)
    srv = tsv.ContinuousBatcher(tp, tcfg, max_batch=2, paged=True,
                                block_size=BS, device="cpu")
    prompt = list(np.random.RandomState(6).randint(0, 97, 13))
    srv.admit(prompt, 4)
    blocks = srv._lane_blocks[0]
    assert len(blocks) == 2                      # positions 0..13
    padded = torch.zeros((1, 16), dtype=torch.long)
    padded[0, :13] = torch.tensor(prompt)
    _, row = ttf.prefill_chunk(tp, ttf.init_cache(tcfg, 1, "cpu"), padded, 0,
                               tcfg, logits_row=12)
    ids = torch.tensor(blocks)
    for layer_pool, layer_row in zip(srv._pool, row):
        for name in ("k", "ks", "v", "vs"):
            want = layer_row[name][0, :2 * BS].reshape(
                (2, BS) + tuple(layer_pool[name].shape[2:]))
            assert torch.equal(layer_pool[name][ids], want), name
        assert layer_pool["ks"][ids].min() > 0
