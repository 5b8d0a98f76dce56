"""The port's decode-attention kernels held against the JAX package, on
the CPU.

On CPU tensors each wrapper of ``mxnet_tpu_torch.kernels`` runs its plain
PyTorch version; these tests hold that plain version against the JAX
package's Pallas kernel, run in interpret mode as the JAX package's own
tests run it (``tests/test_paged_kernel.py``). The CUDA kernels
themselves are held against the same plain versions on the GPU by
``chip_smoke.py``.
"""

import importlib
import importlib.util
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.kernels import paged_attention as jax_paged_attention
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.kernels import _build, common
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

# the JAX package re-exports its flash_attention function under the
# submodule's name: import the module explicitly
jax_flash = importlib.import_module("mxnet_tpu.kernels.flash_attention")


def _paged_setup(rng, span, g, b=3, kvh=2, d=8, bs=8, nb=4):
    """Pool, permuted per-lane tables with null-block tails, and ragged
    positions including a partial last block and a lane ending at the
    table's capacity; lane 0 sits at position 0 like a parked lane."""
    nblocks = 1 + b * nb
    pool = {n: rng.randn(nblocks, bs, kvh, d).astype(np.float32)
            for n in ("k", "v")}
    pos = np.array([0, 13, nb * bs - span])[:b].astype(np.int32)
    tables = np.zeros((b, nb), np.int32)
    for i in range(b):
        need = -(-(pos[i] + span) // bs)
        perm = rng.permutation(nb)
        tables[i, :need] = 1 + i * nb + perm[:need]
    q = rng.randn(b, span, kvh * g, d).astype(np.float32)
    return q, pool, tables, pos


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("span", [1, 3])
@pytest.mark.parametrize("g", [1, 2])
def test_paged_attention_matches_jax_kernel(span, g):
    """fp32 at 1e-5: the same products summed in another order."""
    q, pool, tables, pos = _paged_setup(np.random.RandomState(span + 4 * g),
                                        span, g)
    want = np.asarray(jax_paged_attention(
        jnp.asarray(q), {n: jnp.asarray(a) for n, a in pool.items()},
        jnp.asarray(tables), jnp.asarray(pos), interpret=True))
    tpool = {n: _t(a) for n, a in pool.items()}
    ref = kernels.paged_attention_reference(_t(q), tpool, _t(tables),
                                            _t(pos))
    got = kernels.paged_attention(_t(q), tpool, _t(tables), _t(pos))
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(ref.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_paged_attention_bf16_casts_probabilities():
    """bf16 pools: the normalised probabilities are rounded to bf16
    before PV, as the JAX kernel rounds them. Tolerance: one bf16 output
    rounding (2^-8 relative)."""
    q, pool, tables, pos = _paged_setup(np.random.RandomState(9), 2, 2)
    want = np.asarray(jax_paged_attention(
        jnp.asarray(q, jnp.bfloat16),
        {n: jnp.asarray(a, jnp.bfloat16) for n, a in pool.items()},
        jnp.asarray(tables), jnp.asarray(pos), interpret=True)
        .astype(jnp.float32))
    got = kernels.paged_attention(
        _t(q).bfloat16(), {n: _t(a).bfloat16() for n, a in pool.items()},
        _t(tables), _t(pos))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2,
                               atol=1e-2)


def test_paged_attention_refuses_int8_and_bad_layouts():
    """An int8 pool (detected by its scale planes) must hold int8 codes
    and fp32 planes of the pool's [NB, bs, KVH] shape; q's heads must be
    a multiple of the KV heads."""
    q, pool, tables, pos = _paged_setup(np.random.RandomState(1), 1, 1)
    tpool = {n: _t(a) for n, a in pool.items()}
    planes = torch.ones(tpool["k"].shape[:3])
    with pytest.raises(TypeError, match="int8 codes"):
        kernels.paged_attention(_t(q), dict(tpool, ks=planes, vs=planes),
                                _t(tables), _t(pos))
    codes = {n: torch.zeros(tpool[n].shape, dtype=torch.int8)
             for n in ("k", "v")}
    with pytest.raises(ValueError, match="scale planes"):
        kernels.paged_attention(_t(q), dict(codes, ks=planes[:1], vs=planes),
                                _t(tables), _t(pos))
    with pytest.raises(ValueError, match="query heads"):
        kernels.paged_attention(_t(q)[:, :, :1].repeat(1, 1, 3, 1), tpool,
                                _t(tables), _t(pos))


def test_flash_decode_matches_jax_kernel():
    """dense_decode_with_lse (the plain version the CPU runs) vs the JAX
    flash-decode kernel, GQA, lengths including 0 and the full cache.
    fp32 at 1e-5; an empty row gives o=0 and lse ~ -1e30 in both."""
    rng = np.random.RandomState(3)
    b, h, kvh, t, d = 4, 4, 2, 32, 8
    q = rng.randn(b, h, d).astype(np.float32)
    k = rng.randn(b, t, kvh, d).astype(np.float32)
    v = rng.randn(b, t, kvh, d).astype(np.float32)
    lengths = np.array([0, 5, 17, t], np.int32)
    o_j, lse_j = jax_flash.flash_decode_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        block_k=8, interpret=True)
    o_p, lse_p = kernels.dense_decode_with_lse(_t(q), _t(k), _t(v),
                                               _t(lengths))
    np.testing.assert_allclose(o_p.numpy(), np.asarray(o_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lse_p.numpy(), np.asarray(lse_j), rtol=1e-5,
                               atol=1e-5)
    assert (o_p[0] == 0).all() and (lse_p[0] < -1e29).all()
    o_w, lse_w = kernels.flash_decode_with_lse(_t(q), _t(k), _t(v),
                                               _t(lengths))
    np.testing.assert_array_equal(o_w.numpy(), o_p.numpy())
    np.testing.assert_array_equal(lse_w.numpy(), lse_p.numpy())
    # a scalar length broadcasts over the batch
    o_s = kernels.flash_decode(_t(q), _t(k), _t(v), 9)
    o_b = kernels.flash_decode(_t(q), _t(k), _t(v),
                               _t(np.full(b, 9, np.int32)))
    np.testing.assert_array_equal(o_s.numpy(), o_b.numpy())


def test_block_rules_match_the_jax_package():
    from mxnet_tpu.kernels import common as jax_common
    for t, m in ((4096, 16), (384, 1), (96, 16), (100, 1)):
        assert common.choose_block_k(t, multiple=m) == \
            jax_common.choose_block_k(t, shape_key=("torch-port", t, m),
                                      multiple=m)
    for block, seq in ((128, 4096), (128, 96), (128, 8)):
        assert common.adjust_block(block, seq, "block_k") == \
            jax_common.adjust_block(block, seq, "block_k")
    assert common.NEG_INF == jax_common.NEG_INF


@pytest.mark.parametrize("case, error", [
    ("ok", "run on a CUDA device"),
    ("fp16", "float32 or bfloat16"),
    ("head_dim", "head dim"),
    ("rows", "query rows"),
    ("int_dtype", "int32"),
    ("mixed", "share one dtype"),
    ("strided", "contiguous"),
    ("unaligned", "aligned"),
])
def test_cuda_inputs_are_validated(case, error):
    """What a CUDA wrapper hands its kernel is checked before the launch:
    a supported dtype, head dim and row count, int32 indices, one float
    dtype, contiguity and 16-byte alignment — and last, a CUDA device."""
    q = torch.zeros(2, 4, 64)
    cache = torch.zeros(2, 16, 4, 64)
    idx = torch.zeros(2, dtype=torch.int32)
    d, rows = 64, 1
    if case == "fp16":
        q, cache = q.half(), cache.half()
    elif case == "head_dim":
        d = 48                               # 12 fp32 vectors: not 2^k
    elif case == "rows":
        rows = common.MAX_ROWS + 1
    elif case == "int_dtype":
        idx = idx.long()
    elif case == "mixed":
        cache = cache.bfloat16()
    elif case == "strided":
        cache = cache.transpose(1, 2)
    elif case == "unaligned":
        cache = torch.zeros(2 * 16 * 4 * 64 + 1)[1:].reshape(2, 16, 4, 64)
    with pytest.raises((ValueError, TypeError), match=error):
        common.check_cuda_inputs((q, cache, idx), (idx,), d, rows)


def test_build_is_keyed_by_source_and_reports_nvcc_failure(tmp_path,
                                                          monkeypatch):
    """A library is named by the hash of its source and flags, so an
    edited source rebuilds; a failed compile raises with the compiler's
    output and leaves no library behind."""
    src = tmp_path / "decode_attention.cu"
    src.write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    first = _build.library_path("decode_attention")
    assert first.parent == tmp_path / "build"
    src.write_text("// v2\n")
    assert _build.library_path("decode_attention") != first
    monkeypatch.setattr(_build, "nvcc_path", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.load("decode_attention")
    assert not list((tmp_path / "build").glob("*.so"))


def test_build_is_keyed_by_every_header_the_source_includes(tmp_path,
                                                            monkeypatch):
    """A header the source includes (directly or through another header)
    is part of the library's key, so an edited template rebuilds; a
    header it does not include, or a system include, is not."""
    (tmp_path / "flash_attention.cu").write_text(
        '#include <cuda.h>\n#include "tile.cuh"\n// body\n')
    (tmp_path / "tile.cuh").write_text('#include "mma.cuh"\n// v1\n')
    (tmp_path / "mma.cuh").write_text("// v1\n")
    (tmp_path / "other.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    assert [p.name for p in _build.sources("flash_attention")] == [
        "flash_attention.cu", "tile.cuh", "mma.cuh"]
    first = _build.library_path("flash_attention")
    (tmp_path / "other.cuh").write_text("// v2\n")
    assert _build.library_path("flash_attention") == first
    (tmp_path / "mma.cuh").write_text("// v2\n")
    second = _build.library_path("flash_attention")
    assert second != first
    (tmp_path / "tile.cuh").write_text('#include "mma.cuh"\n// v2\n')
    assert _build.library_path("flash_attention") not in (first, second)


FLASH_SOURCES = ("flash_attention.cu", "sm90_common.cuh",
                 "flash_fwd_sm90.cuh", "flash_bwd_sm90.cuh")


def test_flash_library_is_keyed_by_both_tensor_core_templates(tmp_path,
                                                              monkeypatch):
    """The flash library's source list holds the shared Hopper primitives
    and both tensor-core templates, so an edit to any of them (in a copy
    of the real sources) rebuilds the library."""
    assert set(FLASH_SOURCES) <= {
        p.name for p in _build.sources("flash_attention")}
    for path in _build.CSRC.iterdir():
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    seen = {_build.library_path("flash_attention")}
    for name in FLASH_SOURCES:
        with open(tmp_path / name, "a") as f:
            f.write("// edited\n")
        seen.add(_build.library_path("flash_attention"))
    assert len(seen) == 1 + len(FLASH_SOURCES)


def _chip_smoke():
    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_smoke_times_the_paged_kernel_on_a_full_pool_of_distinct_blocks():
    """The paged kernel's timing case is the served pool full, laid out as
    the batcher maps lanes: every usable block in exactly one table, each
    lane covering its live length and no more."""
    cs = _chip_smoke()
    q, pool, tables, pos = cs.full_pool_case(torch, torch.device("cpu"),
                                             torch.bfloat16, seed=11)
    nb, bs = pool["k"].shape[:2]
    t, p = tables.numpy(), pos.numpy()
    live = t[t > 0]
    assert sorted(live) == list(range(1, nb))
    assert ((t > 0).sum(1) == -(-(p + 1) // bs)).all()
    assert q.shape == (len(p), 1, pool["k"].shape[2], pool["k"].shape[3])


def test_smoke_bf16_tolerance_allows_one_ulp_and_catches_a_bias():
    """A one-ulp difference at any magnitude passes the bfloat16 check; a
    bias of a third of a typical output (0.01 on outputs of ~0.03) fails."""
    cs = _chip_smoke()
    want = torch.from_numpy(
        np.random.RandomState(0).randn(4096).astype(np.float32)) * 0.05
    want[:4] = torch.tensor([3.0, -0.7, 0.02, 0.0])
    want = want.bfloat16().float()
    ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    cs.compare(want + ulp, want, "bfloat16", "one ulp")
    with pytest.raises(AssertionError, match="disagrees"):
        cs.compare(want + 0.01, want, "bfloat16", "biased")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smoke_int8_check_allows_one_code_flip_and_catches_a_bias(dtype):
    """The int8 kernel check allows TOL plus one probability code: one
    row whose elements all moved by a flipped code (as_ times a V code of
    up to 127, i.e. up to the row's code step 127 as_) passes, as one row
    of 256 is inside INT8_CODE_SHARE; a bias of a third of a code step on
    every element fails, by the share. Outputs ~0.03, code steps of
    0.0045-0.0075 (a third is above bf16's TOL at these outputs)."""
    cs = _chip_smoke()
    rng = np.random.RandomState(1)
    want = torch.from_numpy(rng.randn(32, 1, 8, 64).astype(np.float32)) * 0.03
    want = want.to(getattr(torch, dtype)).float()
    step = torch.from_numpy(rng.uniform(0.0045, 0.0075, (32, 1, 8, 1))
                            .astype(np.float32))
    flipped = want.clone()
    codes = torch.from_numpy(rng.randint(-127, 128, 64).astype(np.float32))
    flipped[3, 0, 5] += step[3, 0, 5] * codes / 127
    _, share = cs.compare_int8(flipped, want, step, dtype, "one code")
    assert 0 < share <= cs.INT8_CODE_SHARE
    with pytest.raises(AssertionError, match="disagrees"):
        cs.compare_int8(want + step / 3, want, step, dtype, "biased")
    with pytest.raises(AssertionError, match="disagrees"):
        cs.compare_int8(flipped + 2 * step * (flipped != want), want, step,
                        dtype, "two codes")
