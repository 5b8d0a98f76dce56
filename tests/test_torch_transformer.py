"""The port's transformer serving path held against the JAX package, on
the CPU, at a small size (vocab 97, d_model 32, 4 heads over 2 KV heads,
2 layers, d_ff 64, max_len 64, fp32).

Both packages draw their weights from one numpy seed; inputs are numpy
arrays handed to both. Logits agree at atol 1e-4 (fp32, the same
products summed in another order); greedy streams agree exactly.
"""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu_torch import parallel
from mxnet_tpu_torch.models import convert
from mxnet_tpu_torch.models import transformer as ttf
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

jtf = importlib.import_module("mxnet_tpu.models.transformer")

CFG = dict(vocab_size=97, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=64, max_len=64)
BS = 8
ATOL = 1e-4


def _cfgs(**over):
    kw = dict(CFG, **over)
    return jtf.TransformerConfig(**kw), ttf.TransformerConfig(**kw)


def _models(seed=0, **over):
    jcfg, tcfg = _cfgs(**over)
    return (jcfg, jtf.init_params(jcfg, seed=seed), tcfg,
            ttf.init_params(tcfg, seed=seed, device="cpu"))


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


def _close(got, want, what):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=ATOL,
                               err_msg=what)


def _smallest_gap(logits):
    """Smallest top-1/top-2 logit gap over the rows: a stream can only
    flip where this is below the numeric noise."""
    top = np.sort(np.asarray(logits, np.float64), axis=-1)[..., -2:]
    return float((top[..., 1] - top[..., 0]).min())


def test_init_params_same_draws_and_round_trip():
    jcfg, jp, tcfg, tp = _models(seed=5)
    tree = convert.params_to_numpy(tp)
    jtree = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(tree) == jax.tree.structure(jtree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(a, b)
    back = convert.params_from_jax(jtree, tcfg, device="cpu")
    for (name, a), b in zip(tp.named_parameters(), back.parameters()):
        assert torch.equal(a, b), name
    # bf16 trees carry over bit for bit through the numpy bfloat16 type
    bcfg = ttf.TransformerConfig(**dict(CFG, dtype=torch.bfloat16))
    jb = jtf.init_params(jtf.TransformerConfig(**dict(CFG,
                                                      dtype=jnp.bfloat16)))
    tb = convert.params_from_jax(jax.tree.map(np.asarray, jb), bcfg, "cpu")
    assert tb.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(tb.embed.float().numpy(),
                                  np.asarray(jb["embed"], np.float32))
    with pytest.raises(ValueError, match="shape"):
        bad = dict(jtree, pos=jtree["pos"][:3])
        convert.params_from_jax(bad, tcfg, device="cpu")


def test_prefill_and_prefill_chunk_match_jax():
    jcfg, jp, tcfg, tp = _models(seed=1)
    toks = np.random.RandomState(0).randint(0, 97, (2, 11)).astype(np.int32)
    jl, jc = jtf.prefill(jp, jtf.init_cache(jcfg, 2), jnp.asarray(toks), jcfg)
    tl, tc = ttf.prefill(tp, ttf.init_cache(tcfg, 2, "cpu"),
                         torch.from_numpy(toks), tcfg)
    _close(tl, jl, "prefill logits")
    for a, b in zip(tc, jc):
        _close(a["k"], b["k"], "prefill cache k")
    # a chunk continuing the same cache, all rows and one row
    more = np.random.RandomState(1).randint(0, 97, (2, 5)).astype(np.int32)
    jl2, _ = jtf.prefill_chunk(jp, jc, jnp.asarray(more), 11, jcfg)
    tl2, _ = ttf.prefill_chunk(tp, tc, torch.from_numpy(more), 11, tcfg)
    _close(tl2, jl2, "prefill_chunk logits")
    tl3, _ = ttf.prefill_chunk(tp, ttf.init_cache(tcfg, 2, "cpu"),
                               torch.from_numpy(toks), 0, tcfg,
                               logits_row=4, attend_limit=16)
    jl3, _ = jtf.prefill_chunk(jp, jtf.init_cache(jcfg, 2),
                               jnp.asarray(toks), 0, jcfg, logits_row=4,
                               attend_limit=16)
    _close(tl3, jl3, "prefill_chunk logits_row")
    with pytest.raises(ValueError, match="overruns"):
        ttf.prefill_chunk(tp, tc, torch.from_numpy(more), 62, tcfg)


@pytest.mark.parametrize("flash", [False, True])
def test_decode_step_matches_jax(flash):
    """Scalar and ragged positions; with use_flash_kernel the JAX side
    runs its flash-decode kernel in interpret mode and the port the
    kernel's plain version."""
    jcfg, jp, tcfg, tp = _models(seed=2, use_flash_kernel=flash)
    rng = np.random.RandomState(3)
    toks = rng.randint(0, 97, (3, 9)).astype(np.int32)
    _, jc = jtf.prefill(jp, jtf.init_cache(jcfg, 3), jnp.asarray(toks), jcfg)
    _, tc = ttf.prefill(tp, ttf.init_cache(tcfg, 3, "cpu"),
                        torch.from_numpy(toks), tcfg)
    tok = rng.randint(0, 97, 3).astype(np.int32)
    jl, jc = jtf.decode_step(jp, jc, jnp.asarray(tok), jnp.int32(9), jcfg)
    tl, tc = ttf.decode_step(tp, tc, torch.from_numpy(tok), 9, tcfg)
    _close(tl, jl, "decode_step logits")
    pos = np.array([10, 4, 9], np.int32)
    jl, jc = jtf.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos), jcfg)
    tl, tc = ttf.decode_step(tp, tc, torch.from_numpy(tok),
                             torch.from_numpy(pos), tcfg)
    _close(tl, jl, "ragged decode_step logits")
    for a, b in zip(tc, jc):
        _close(a["v"], b["v"], "ragged cache v")


def _paged_inputs(rng, lanes=3):
    nb = CFG["max_len"] // BS
    tables = np.zeros((lanes, nb), np.int32)
    for i in range(1, lanes):                 # lane 0: parked, all-null
        tables[i] = 1 + (i - 1) * nb + rng.permutation(nb)
    pos = np.array([0, 13, 40, 7][:lanes], np.int32)
    tok = rng.randint(0, 97, lanes).astype(np.int32)
    return 1 + (lanes - 1) * nb, tables, pos, tok


def test_decode_step_paged_matches_jax():
    """Three steps through shared pools: logits at atol 1e-4 and pools
    equal at every position the lanes wrote."""
    jcfg, jp, tcfg, tp = _models(seed=4)
    rng = np.random.RandomState(4)
    nblocks, tables, pos, tok = _paged_inputs(rng)
    jpool = jtf.init_paged_cache(jcfg, nblocks, BS)
    tpool = ttf.init_paged_cache(tcfg, nblocks, BS, "cpu")
    # identical random pool contents, so attention reads history
    for jl_, tl_ in zip(jpool, tpool):
        for name in ("k", "v"):
            arr = rng.randn(*tl_[name].shape).astype(np.float32)
            jl_[name] = jnp.asarray(arr)
            tl_[name].copy_(torch.from_numpy(arr))
    jt, tt = jnp.asarray(tables), torch.from_numpy(tables)
    for step in range(3):
        p = pos + step
        jl, jpool = jtf.decode_step_paged(jp, jpool, jt, jnp.asarray(tok),
                                          jnp.asarray(p), jcfg)
        tl, tpool = ttf.decode_step_paged(tp, tpool, tt,
                                          torch.from_numpy(tok),
                                          torch.from_numpy(p), tcfg)
        _close(tl, jl, "paged logits, step %d" % step)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for a, b in zip(tpool, jpool):
        _close(a["k"], b["k"], "pool k")
        _close(a["v"], b["v"], "pool v")


def test_paged_pool_geometry_matches_jax():
    jcfg, tcfg = _cfgs()
    pool = ttf.init_paged_cache(tcfg, 9, BS, "cpu")
    assert len(pool) == CFG["n_layers"]
    assert tuple(pool[0]["k"].shape) == tuple(
        jtf.init_paged_cache(jcfg, 9, BS)[0]["k"].shape)
    assert ttf.paged_cache_nbytes(tcfg, 9, BS) == \
        jtf.paged_cache_nbytes(jcfg, 9, BS) == \
        sum(t.nbytes for layer in pool for t in layer.values())
    with pytest.raises(ValueError, match="null block"):
        ttf.init_paged_cache(tcfg, 1, BS, "cpu")


def test_paged_write_past_the_table_is_dropped_like_jax():
    """A lane at pos >= max_len: JAX's take_along_axis fills the table
    index with INT_MIN and the scatter drops the write, and its position
    row reads as NaN. The port reproduces both; other lanes are
    unaffected."""
    jcfg, jp, tcfg, tp = _models(seed=6)
    rng = np.random.RandomState(6)
    nblocks, tables, _, tok = _paged_inputs(rng)
    pos = np.array([5, 64, 70], np.int32)
    jl, jpool = jtf.decode_step_paged(
        jp, jtf.init_paged_cache(jcfg, nblocks, BS), jnp.asarray(tables),
        jnp.asarray(tok), jnp.asarray(pos), jcfg)
    tl, tpool = ttf.decode_step_paged(
        tp, ttf.init_paged_cache(tcfg, nblocks, BS, "cpu"),
        torch.from_numpy(tables), torch.from_numpy(tok),
        torch.from_numpy(pos), tcfg)
    jl, tl = np.asarray(jl), tl.numpy()
    np.testing.assert_array_equal(np.isnan(tl), np.isnan(jl))
    assert np.isnan(tl[1:]).all() and np.isfinite(tl[0]).all()
    _close(tl[0], jl[0], "in-range lane")
    for a, b in zip(tpool, jpool):
        _close(a["k"], b["k"], "pool k")
        # only lane 0's write (null block 0, offset 5) landed
        assert not a["k"][1:].any() and not np.asarray(b["k"])[1:].any()


@pytest.mark.parametrize("flash", [False, True])
def test_generate_matches_jax(flash):
    jcfg, jp, tcfg, tp = _models(seed=7, use_flash_kernel=flash)
    prompt = np.random.RandomState(7).randint(0, 97, (3, 10)).astype(np.int32)
    want = np.asarray(jtf.generate(jp, jnp.asarray(prompt), 12, jcfg))
    got = ttf.generate(tp, prompt, 12, tcfg, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (3, 22)
    if not np.array_equal(got.numpy(), want):
        logits, _ = jtf.prefill_chunk(jp, jtf.init_cache(jcfg, 3),
                                      jnp.asarray(want[:, :-1]), 0, jcfg)
        pytest.fail("streams differ; smallest top-1/top-2 gap on the JAX "
                    "stream: %g" % _smallest_gap(logits[:, 9:]))
    assert ttf.generate(tp, prompt, 0, tcfg, device="cpu").shape == (3, 10)


def test_entry_points_need_cuda_unless_told(monkeypatch):
    """No device given means the GPU: without one the entry points raise
    rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttf.init_params(tcfg)
    tp = ttf.init_params(tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttf.generate(tp, np.zeros((1, 4), np.int32), 2, tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttf.init_cache(tcfg, 1)


@pytest.mark.parametrize("field, value", [("pp_axis", "pp")])
def test_unported_config_fields_raise(field, value):
    """The serving paths carry a pipelined config (pipeline stages matter
    only under a mesh with a pp axis, as in JAX): its caches are the
    plain config's and its greedy stream is JAX's on the same config."""
    jcfg, tcfg = _cfgs(**{field: value})
    _, plain = _cfgs()
    for got, want in ((ttf.init_cache(tcfg, 1, "cpu"),
                       ttf.init_cache(plain, 1, "cpu")),
                      (ttf.init_paged_cache(tcfg, 4, BS, "cpu"),
                       ttf.init_paged_cache(plain, 4, BS, "cpu"))):
        assert [{n: t.shape for n, t in layer.items()} for layer in got] \
            == [{n: t.shape for n, t in layer.items()} for layer in want]
    tp = ttf.init_params(tcfg, seed=3, device="cpu")
    prompt = np.random.RandomState(3).randint(0, 97, (2, 6)).astype(np.int32)
    want = jtf.generate(jtf.init_params(jcfg, seed=3), jnp.asarray(prompt),
                        5, jcfg)
    np.testing.assert_array_equal(
        ttf.generate(tp, prompt, 5, tcfg, device="cpu").numpy(),
        np.asarray(want))


def test_unported_decoding_controls_raise():
    """generate(mesh=...) runs (a world of one: the unsharded stream);
    greedy with a sampling control is a contradiction, as in JAX; an
    int8 weight tree loads through convert (its streams are held against
    JAX in tests/test_torch_int8_weights.py). (Sampling:
    tests/test_torch_sampling.py.)"""
    _, tcfg = _cfgs()
    tp = ttf.init_params(tcfg, device="cpu")
    prompt = np.zeros((1, 4), np.int32)
    mesh = parallel.make_mesh({"dp": 1, "tp": 1}, device="cpu")
    assert torch.equal(ttf.generate(tp, prompt, 2, tcfg, mesh=mesh),
                       ttf.generate(tp, prompt, 2, tcfg, device="cpu"))
    with pytest.raises(ValueError, match="greedy=True"):
        ttf.generate(tp, prompt, 2, tcfg, greedy=True, top_k=3,
                     device="cpu")
    q8 = {"q8": np.zeros((97, 32), np.int8),
          "scale": np.ones((1, 32), np.float32), "dt": "float32"}
    tree = dict(convert.params_to_numpy(tp), embed=q8)
    got = convert.params_from_jax(tree, tcfg, device="cpu")
    assert isinstance(got.embed, ttf.Q8Weight)
    assert torch.equal(ttf._w(got.embed), torch.zeros(97, 32))


def test_generate_positional_order_is_the_references():
    """generate()'s positional parameters are the JAX package's, in its
    order (the port adds ``device`` last): the sixth is ``seed``, so
    ``generate(p, x, n, cfg, None, 3)`` samples with seed 3 in both, never
    at temperature 3."""
    import inspect
    want = list(inspect.signature(jtf.generate).parameters)
    got = list(inspect.signature(ttf.generate).parameters)
    assert got == want + ["device"]
    _, tcfg = _cfgs()
    tp = ttf.init_params(tcfg, device="cpu")
    prompt = np.random.RandomState(9).randint(0, 97, (2, 5)).astype(np.int32)
    by_position = ttf.generate(tp, prompt, 6, tcfg, False, 3, 0.9, 20, 0.95,
                               None, "cpu")
    by_name = ttf.generate(tp, prompt, 6, tcfg, greedy=False, seed=3,
                           temperature=0.9, top_k=20, top_p=0.95,
                           device="cpu")
    assert torch.equal(by_position, by_name)


def test_long_prefill_needs_the_flash_kernel(monkeypatch):
    """With use_flash_kernel the port routes prefill through the flash
    attention kernel at every prompt length (on CPU tensors its plain
    version): the JAX package's TPU-measured crossover
    MXNET_FLASH_MIN_SEQ is not read. The logits match the dense route's
    at atol 1e-4 (fp32, the same products summed in another order)."""
    from mxnet_tpu_torch.kernels import flash_attention as fa_fn
    _, tcfg = _cfgs(use_flash_kernel=True)
    _, dcfg = _cfgs()
    tp = ttf.init_params(tcfg, device="cpu")
    calls = []

    def counted(*args, **kwargs):
        calls.append(args[0].shape[1])
        return fa_fn(*args, **kwargs)

    monkeypatch.setattr(ttf, "flash_attention", counted)
    toks = torch.from_numpy(
        np.random.RandomState(8).randint(0, 97, (1, 9)).astype(np.int64))
    for min_seq in ("8", "100000"):
        monkeypatch.setenv("MXNET_FLASH_MIN_SEQ", min_seq)
        for t in (7, 9):
            calls.clear()
            got, _ = ttf.prefill(tp, ttf.init_cache(tcfg, 1, "cpu"),
                                 toks[:, :t], tcfg)
            assert calls == [t] * CFG["n_layers"]
            want, _ = ttf.prefill(tp, ttf.init_cache(dcfg, 1, "cpu"),
                                  toks[:, :t], dcfg)
            _close(got, want, "flash vs dense prefill, T=%d" % t)
