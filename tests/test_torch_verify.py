"""The port's ragged verify windows (``verify_chunk``,
``verify_chunk_paged``) held against the JAX package on the CPU, at the
size of tests/test_torch_serving_dense.py (vocab 97, d_model 32, 4 heads
over 2 KV heads, 2 layers, max_len 64, fp32), fp32 and int8 caches.

The same seeded numpy tokens go through both packages' functions (the
JAX ones jitted), each starting from its own prefilled cache (the same
weights, prefilled the same way). On CPU tensors the port's paged
window runs the paged kernel's plain version, which is the JAX
function's gather path.

Tolerances. Logits and float cache rows agree to atol 1e-5 (the two
packages' matmuls sum in another order, about 3e-7 apart here); int8
codes agree exactly and their scales to rtol 1e-5 on these inputs.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.kernels import common, paged_decode
from mxnet_tpu_torch.models import transformer as ttf
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

jtf = importlib.import_module("mxnet_tpu.models.transformer")

CFG = dict(vocab_size=97, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=64, max_len=64)
V, T = CFG["vocab_size"], CFG["max_len"]
BS = 8
ATOL = 1e-5


def _jit(fn, cfg):
    """The JAX function with its config bound, jitted: eager JAX would
    compile each op on its first use."""
    return jax.jit(lambda *args: fn(*args, cfg))


def _models(int8, **over):
    jcfg = jtf.TransformerConfig(**dict(CFG, kv_cache_int8=int8, **over))
    tcfg = ttf.TransformerConfig(**dict(CFG, kv_cache_int8=int8, **over))
    return (jcfg, jtf.init_params(jcfg, seed=3), tcfg,
            ttf.init_params(tcfg, seed=3, device="cpu"))


def _assert_leaves(got, want, what):
    for name in want:
        w = np.asarray(want[name])
        g = got[name].numpy()
        if w.dtype == np.int8:
            np.testing.assert_array_equal(g, w, err_msg="%s %s" % (what, name))
        elif name in ("ks", "vs"):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0,
                                       err_msg="%s %s" % (what, name))
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL,
                                       err_msg="%s %s" % (what, name))


def _tables(b, full=True):
    """Lane b's table maps its own blocks 1 + b*NB ...; with ``full``
    False lane 0 holds only 3 blocks, the rest of its entries null."""
    nb = T // BS
    tables = np.stack([1 + b_ * nb + np.arange(nb) for b_ in range(b)])
    if not full:
        tables[0, 3:] = 0
    return tables.astype(np.int32)


@pytest.mark.parametrize("int8", [False, True])
def test_verify_chunk_matches_jax(int8):
    """Ragged windows at their own positions, one of them running past
    max_len: logits of every in-range row and the whole cache agree with
    JAX's; the rows past max_len write nothing."""
    jcfg, jp, tcfg, tp = _models(int8)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, V, (3, 24))
    jc = jtf.init_cache(jcfg, 3)
    tc = ttf.init_cache(tcfg, 3, "cpu")
    _, jc = _jit(jtf.prefill_chunk, jcfg)(jp, jc, jnp.asarray(toks), 0)
    _, tc = ttf.prefill_chunk(tp, tc, torch.from_numpy(toks), 0, tcfg)
    pos = np.array([5, 23, T - 2], np.int32)
    win = rng.randint(0, V, (3, 4))
    jl, jc = _jit(jtf.verify_chunk, jcfg)(jp, jc, jnp.asarray(win),
                                          jnp.asarray(pos))
    tl, tc = ttf.verify_chunk(tp, tc, torch.from_numpy(win),
                              torch.from_numpy(pos), tcfg)
    jl, tl = np.asarray(jl), tl.numpy()
    live = (pos[:, None] + np.arange(4)[None]) < T
    np.testing.assert_allclose(tl[live], jl[live], rtol=0, atol=ATOL)
    for i, (jlayer, tlayer) in enumerate(zip(jc, tc)):
        _assert_leaves(tlayer, jlayer, "layer %d" % i)


def test_writes_past_max_len_are_dropped():
    """A window from max_len - 2: its first two rows land in the last two
    positions, the two past the end are dropped, not clamped onto the
    last row, and no other row moves (both packages)."""
    jcfg, jp, tcfg, tp = _models(False)
    rng = np.random.RandomState(1)
    toks = rng.randint(0, V, (2, 8))
    tc = ttf.init_cache(tcfg, 2, "cpu")
    _, tc = ttf.prefill_chunk(tp, tc, torch.from_numpy(toks), 0, tcfg)
    before = [{n: leaf.clone() for n, leaf in layer.items()} for layer in tc]
    win = rng.randint(0, V, (2, 4))
    pos = np.array([T - 2, 3], np.int32)
    _, tc = ttf.verify_chunk(tp, tc, torch.from_numpy(win),
                             torch.from_numpy(pos), tcfg)
    # the same window row by row at positions T-2 and T-1 alone
    ref = [{n: leaf.clone() for n, leaf in layer.items()} for layer in before]
    _, ref = ttf.verify_chunk(tp, ref, torch.from_numpy(win[:, :2]),
                              torch.from_numpy(pos), tcfg)
    for layer, want, old in zip(tc, ref, before):
        for name in layer:
            assert torch.equal(layer[name][0], want[name][0])
            assert torch.equal(layer[name][0, :T - 2], old[name][0, :T - 2])
            assert torch.equal(layer[name][1, 7:], want[name][1, 7:])
    jc = jtf.init_cache(jcfg, 2)
    _, jc = _jit(jtf.prefill_chunk, jcfg)(jp, jc, jnp.asarray(toks), 0)
    _, jc = _jit(jtf.verify_chunk, jcfg)(jp, jc, jnp.asarray(win),
                                         jnp.asarray(pos))
    for i, (jlayer, tlayer) in enumerate(zip(jc, tc)):
        _assert_leaves(tlayer, jlayer, "layer %d" % i)


@pytest.mark.parametrize("int8", [False, True])
def test_verify_chunk_paged_matches_jax(int8):
    """The paged window: logits of every in-range row and every pool
    block agree with JAX's. One lane's window crosses max_len (its rows
    past the table go to the null block, left out of the comparison);
    every lane's table is fully mapped here, because JAX's position
    ``take`` fills such rows with NaN, which then reach any lane that
    gathers the null block (test_paged_window_past_max_len_stays_finite
    holds the port there)."""
    jcfg, jp, tcfg, tp = _models(int8)
    rng = np.random.RandomState(2)
    b = 3
    nblocks = b * (T // BS) + 1
    tables = _tables(b)
    toks = rng.randint(0, V, (b, 16))
    jpool = jtf.init_paged_cache(jcfg, nblocks, BS)
    tpool = ttf.init_paged_cache(tcfg, nblocks, BS, "cpu")
    zero = np.zeros(b, np.int32)
    paged = _jit(jtf.verify_chunk_paged, jcfg)
    _, jpool = paged(jp, jpool, jnp.asarray(tables), jnp.asarray(toks),
                     jnp.asarray(zero))
    _, tpool = ttf.verify_chunk_paged(tp, tpool, torch.from_numpy(tables),
                                      torch.from_numpy(toks),
                                      torch.from_numpy(zero), tcfg)
    pos = np.array([16, 9, T - 3], np.int32)
    win = rng.randint(0, V, (b, 5))
    jl, jpool = paged(jp, jpool, jnp.asarray(tables), jnp.asarray(win),
                      jnp.asarray(pos))
    tl, tpool = ttf.verify_chunk_paged(tp, tpool, torch.from_numpy(tables),
                                       torch.from_numpy(win),
                                       torch.from_numpy(pos), tcfg)
    jl, tl = np.asarray(jl), tl.numpy()
    live = (pos[:, None] + np.arange(5)[None]) < T
    np.testing.assert_allclose(tl[live], jl[live], rtol=0, atol=ATOL)
    for i, (jlayer, tlayer) in enumerate(zip(jpool, tpool)):
        _assert_leaves({n: leaf[1:] for n, leaf in tlayer.items()},
                       {n: np.asarray(leaf)[1:] for n, leaf in jlayer.items()},
                       "layer %d" % i)


@pytest.mark.parametrize("int8", [False, True])
def test_paged_window_past_max_len_stays_finite(int8):
    """A lane's window past max_len writes its rows into the null block;
    a lane whose table holds null entries reads that block only at
    masked positions, and its logits stay finite and equal a run without
    the overrunning lane."""
    _, _, tcfg, tp = _models(int8)
    rng = np.random.RandomState(4)
    nblocks = 2 * (T // BS) + 1
    tables = _tables(2, full=False)
    win = rng.randint(0, V, (2, 4))
    pool = ttf.init_paged_cache(tcfg, nblocks, BS, "cpu")
    alone = ttf.init_paged_cache(tcfg, nblocks, BS, "cpu")
    pos = np.array([10, T - 2], np.int32)
    got, pool = ttf.verify_chunk_paged(tp, pool, torch.from_numpy(tables),
                                       torch.from_numpy(win),
                                       torch.from_numpy(pos), tcfg)
    want, _ = ttf.verify_chunk_paged(tp, alone,
                                     torch.from_numpy(tables[:1]),
                                     torch.from_numpy(win[:1]),
                                     torch.from_numpy(pos[:1]), tcfg)
    assert torch.isfinite(got).all()
    assert all(torch.isfinite(leaf.float()).all()
               for layer in pool for leaf in layer.values())
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("int8", [False, True])
def test_verify_window_equals_stepped_decode(int8):
    """The verify window is the k > 1 case of the decode step: its rows'
    logits are those of decode_step_paged fed the same tokens one
    position at a time (the identity batched speculation rests on)."""
    _, _, tcfg, tp = _models(int8)
    rng = np.random.RandomState(5)
    b = 2
    nblocks = b * (T // BS) + 1
    tables = torch.from_numpy(_tables(b))
    toks = torch.from_numpy(rng.randint(0, V, (b, 12)))
    pool = ttf.init_paged_cache(tcfg, nblocks, BS, "cpu")
    _, pool = ttf.verify_chunk_paged(tp, pool, tables, toks,
                                     torch.zeros(b, dtype=torch.int32), tcfg)
    stepped = [{n: leaf.clone() for n, leaf in layer.items()}
               for layer in pool]
    pos = torch.tensor([12, 7], dtype=torch.int32)
    win = torch.from_numpy(rng.randint(0, V, (b, 4)))
    got, _ = ttf.verify_chunk_paged(tp, pool, tables, win, pos, tcfg)
    for i in range(4):
        want, stepped = ttf.decode_step_paged(tp, stepped, tables, win[:, i],
                                              pos + i, tcfg)
        np.testing.assert_allclose(got[:, i].numpy(), want.numpy(), rtol=0,
                                   atol=ATOL)


def test_span_slices_equal_the_one_piece_window():
    """B3 takes 16 query rows a (lane, KV head): at G = 2 a verify window
    of k = 9 (span 10, 20 rows) runs as slices of 8 and 2 positions, each
    at its own offset, and the slices give the one-piece result."""
    rng = np.random.RandomState(6)
    b, kvh, g, d, span, bs, nbl = 3, 2, 2, 16, 10, 8, 8
    pool = {"k": torch.from_numpy(rng.randn(b * nbl + 1, bs, kvh, d)
                                  .astype(np.float32)),
            "v": torch.from_numpy(rng.randn(b * nbl + 1, bs, kvh, d)
                                  .astype(np.float32))}
    tables = torch.from_numpy(_tables(b))
    q = torch.from_numpy(rng.randn(b, span, kvh * g, d).astype(np.float32))
    pos = torch.tensor([0, 21, 53], dtype=torch.int32)
    calls = []

    def launch(qs, layer_pool, tb, p):
        calls.append((qs.shape[1], p.tolist(), qs.is_contiguous()))
        return paged_decode.paged_attention_reference(qs, layer_pool, tb, p)

    got = paged_decode.span_slices(launch, q, pool, tables, pos)
    want = paged_decode.paged_attention_reference(q, pool, tables, pos)
    assert common.MAX_ROWS == 16
    assert calls == [(8, [0, 21, 53], True), (2, [8, 29, 61], True)]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    calls.clear()
    paged_decode.span_slices(launch, q[:, :8].contiguous(), pool, tables, pos)
    assert calls == [(8, [0, 21, 53], True)]


def test_grow_paged_cache_matches_jax():
    jcfg = _models(True)[0]
    jpool = jtf.init_paged_cache(jcfg, 5, BS)
    rng = np.random.RandomState(7)
    jpool = [{n: jnp.asarray(rng.randint(-5, 5, leaf.shape)
                             .astype(np.asarray(leaf).dtype))
              for n, leaf in layer.items()} for layer in jpool]
    tpool = [{n: torch.from_numpy(np.array(leaf)) for n, leaf in layer.items()}
             for layer in jpool]
    jgrown = jtf.grow_paged_cache(jpool, 3)
    tgrown = ttf.grow_paged_cache(tpool, 3)
    for jlayer, tlayer in zip(jgrown, tgrown):
        for name in jlayer:
            np.testing.assert_array_equal(tlayer[name].numpy(),
                                          np.asarray(jlayer[name]))
    assert ttf.grow_paged_cache(tpool, 0) is tpool
