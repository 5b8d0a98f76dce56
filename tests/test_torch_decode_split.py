"""The split-K arithmetic of the decode kernels B4 (``flash_decode``) and
B3's fp32/bf16 mode (``paged_decode``), modelled in PyTorch on the CPU.

The CUDA kernels of ``csrc/decode_attention.cu`` split each lane's
positions into chunks: B4 writes each chunk's (m, l, unnormalised acc)
and merges the splits in split order into (o, lse); B3's pass 1 writes
each chunk's (m, l) and its scores, pass 2 merges every split's (m, l)
in split order, rounds exp(s - m) / l to the cache dtype and writes its
chunk's PV, and the combine sums the splits in order. The models below
follow those steps split by split and are held against the JAX
package's Pallas kernels (interpret mode, as ``tests/test_paged_kernel.py``
runs them) and against the port's plain versions, which is what the
wrappers run on the CPU. ``chip_smoke.py`` holds the kernels themselves
against the same plain versions on the GPU.

The models are copies of the kernels' arithmetic and must be kept in step
with ``csrc/decode_attention.cu``: ``test_model_follows_the_kernel_source``
pins the lines they copy, so an edit to the kernels' split rule fails
here until the models follow it.
"""

import importlib
import math
import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.kernels import paged_attention as jax_paged_attention
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.kernels import common
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

jax_flash = importlib.import_module("mxnet_tpu.kernels.flash_attention")
torch_flash = importlib.import_module(
    "mxnet_tpu_torch.kernels.flash_attention")
KERNEL_SOURCE = (Path(common.__file__).resolve().parent.parent / "csrc"
                 / "decode_attention.cu")

NEG_INF = common.NEG_INF
# the card's bf16 gate (chip_smoke.TOL): one bf16 ulp of the output, plus
# an atol for a probability whose bf16 rounding flips
TOL_BF16 = dict(atol=1e-3, rtol=2.0 ** -7)
TOL_F32 = dict(atol=1e-5, rtol=1e-5)


def _plan(capacity, splits, multiple=1):
    """(splits, chunk) for a wanted split count, as the kernels take it:
    chunk a multiple of ``multiple`` covering [0, capacity)."""
    chunk = -(-capacity // splits)
    chunk = -(-chunk // multiple) * multiple
    return -(-capacity // chunk), chunk


def lane_chunk(live, splits, chunk, granule):
    """The kernels' ``lane_chunk``: a lane's live length over the splits,
    rounded up to ``granule``, at most the host's ``chunk``."""
    even = -(-max(live, 0) // splits)
    return min(chunk, -(-even // granule) * granule)


# ------------------------------------------------------------------ B4 ---

def flash_split_model(q, k, v, lengths, splits, chunk, granule):
    """B4's split pass and combine, lane by lane: split s of a lane of
    length L covers [s * C, (s + 1) * C) with C = lane_chunk(L, ...); per
    split (m, l, acc) of q pre-scaled by 1/sqrt(D) in fp32, then the
    merge in split order, where a split with l = 0 contributes nothing
    (its acc is never read)."""
    b, h, d = q.shape
    t_max, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qs = q.float().reshape(b, kvh, g, d) * (1.0 / math.sqrt(d))
    o_all, lse_all = [], []
    for lane in range(b):
        length = min(int(lengths[lane]), t_max)
        c = lane_chunk(length, splits, chunk, granule)
        parts = []
        for s in range(splits):
            lo, hi = s * c, min((s + 1) * c, length)
            if lo >= hi:        # an empty split: (m, l) = (-1e30, 0)
                parts.append((torch.full((kvh, g), NEG_INF),
                              torch.zeros(kvh, g), None))
                continue
            sc = torch.einsum("kgd,tkd->kgt", qs[lane],
                              k[lane, lo:hi].float())
            m = sc.amax(-1)
            p = torch.exp(sc - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum(
                "kgt,tkd->kgd", p, v[lane, lo:hi].float())))
        mm = torch.full((kvh, g), NEG_INF)
        for m, _, _ in parts:
            mm = torch.maximum(mm, m)
        ll, o = torch.zeros(kvh, g), torch.zeros(kvh, g, d)
        for m, l, acc in parts:
            if acc is not None:
                a = torch.exp(m - mm)
                ll, o = ll + l * a, o + acc * a[..., None]
        ll = ll.clamp(min=1e-30)
        o_all.append((o / ll[..., None]).reshape(h, d))
        lse_all.append((mm + torch.log(ll)).reshape(h))
    return torch.stack(o_all).to(q.dtype), torch.stack(lse_all)


def _flash_inputs(seed, splits, chunk, granule, b=8, kvh=2, g=2, t_max=64,
                  d=8, dtype=torch.float32):
    """q, k, v and lengths 0, 1, C - 1, C, C + 1 and t_max for the host's
    chunk C, and splits * granule -/+ 1 (where a lane's own chunk steps
    up by one granule), clipped to [0, t_max]."""
    rng = np.random.RandomState(seed)
    lens = np.clip([0, 1, chunk - 1, chunk, chunk + 1, t_max,
                    splits * granule - 1, splits * granule + 1][:b], 0, t_max)
    q = torch.from_numpy(rng.randn(b, kvh * g, d).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(b, t_max, kvh, d).astype(np.float32))
            for _ in range(2))
    return (q.to(dtype), k.to(dtype), v.to(dtype),
            torch.from_numpy(lens.astype(np.int32)))


# (wanted splits, granule): granule None fixes every lane's chunk at the
# host's (granule = chunk); 16 splits of 4 positions leave more splits
# than live chunks in every lane but the full one
FLASH_CASES = [(1, None), (2, None), (7, None), (16, None), (1, 4), (2, 4),
               (7, 4), (16, 4)]


@pytest.mark.parametrize("want,granule", FLASH_CASES)
def test_flash_split_model_matches_jax_kernel_and_plain_fp32(want, granule):
    """fp32 at 1e-5 against the JAX kernel and the plain version, lengths
    on the chunks' edges."""
    splits, chunk = _plan(64, want)
    granule = granule or chunk
    q, k, v, lens = _flash_inputs(want, splits, chunk, granule)
    o, lse = flash_split_model(q, k, v, lens, splits, chunk, granule)
    o_j, lse_j = jax_flash.flash_decode_with_lse(
        *(jnp.asarray(x.numpy()) for x in (q, k, v, lens)), block_k=16,
        interpret=True)
    o_p, lse_p = kernels.dense_decode_with_lse(q, k, v, lens)
    for want_o, want_lse in ((np.asarray(o_j), np.asarray(lse_j)),
                             (o_p.numpy(), lse_p.numpy())):
        np.testing.assert_allclose(o.numpy(), want_o, **TOL_F32)
        np.testing.assert_allclose(lse.numpy(), want_lse, **TOL_F32)
    # the length-0 lane: o = 0 and lse ~ -1e30, so it drops out of
    # sp_flash_decode's combine
    assert (o[0] == 0).all() and (lse[0] < -1e29).all()


@pytest.mark.parametrize("want", [1, 2, 7])
def test_flash_split_model_bf16_within_the_card_gate(want):
    """bf16 q and cache: the split model rounds o to bf16 once, as the
    plain version does; they agree at the card's bf16 gate, and both sit
    within it of the JAX kernel on the same bf16 inputs."""
    splits, chunk = _plan(64, want)
    q, k, v, lens = _flash_inputs(10 + want, splits, chunk, 4,
                                  dtype=torch.bfloat16)
    o, lse = flash_split_model(q, k, v, lens, splits, chunk, 4)
    assert o.dtype == torch.bfloat16
    o_p, lse_p = kernels.flash_decode_with_lse(q, k, v, lens)
    np.testing.assert_allclose(o.float().numpy(), o_p.float().numpy(),
                               **TOL_BF16)
    np.testing.assert_allclose(lse.numpy(), lse_p.numpy(), **TOL_F32)
    o_j, _ = jax_flash.flash_decode_with_lse(
        *(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)),
        jnp.asarray(lens.numpy()), block_k=16, interpret=True)
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(o_j.astype(jnp.float32)),
                               **TOL_BF16)


# ------------------------------------------------------------------ B3 ---

def paged_split_model(q, pool, tables, pos, splits, chunk, granule):
    """B3 lane by lane: with C = lane_chunk(last + 1, ...), pass 1 gives
    each split's (m, l) over [s * C, (s + 1) * C) and the scores; pass 2
    merges the splits' (m, l) in split order, rounds p = exp(s - m) / l
    to the cache dtype and sums each split's PV in fp32; the combine sums
    the splits in order, skipping a split whose l is 0. q: [B, span, H,
    D]."""
    b, span, h, d = q.shape
    bs, kvh = pool["k"].shape[1], pool["k"].shape[2]
    g = h // kvh
    cap = tables.shape[1] * bs
    out = []
    for lane in range(b):
        idx = tables[lane].long()
        ck, cv = (pool[n][idx].reshape(cap, kvh, d).float() for n in "kv")
        scores = torch.einsum("ckgd,tkd->ckgt", q[lane].float().reshape(
            span, kvh, g, d), ck) / math.sqrt(d)
        p0 = int(pos[lane])
        last = min(p0 + span - 1, cap - 1)
        c = lane_chunk(last + 1, splits, chunk, granule)
        attend = torch.arange(cap)[None, :] <= p0 + torch.arange(span)[:, None]
        stats = []
        for s in range(splits):
            lo, hi = s * c, min((s + 1) * c, last + 1)
            if lo >= hi:
                continue        # an empty split: (m, l) = (-1e30, 0)
            mask = attend[:, lo:hi][:, None, None, :]
            sc = torch.where(mask, scores[..., lo:hi], NEG_INF)
            m = sc.amax(-1)
            stats.append((lo, hi, mask, m, torch.where(
                mask, torch.exp(sc - m[..., None]), 0.0).sum(-1)))
        mm = torch.full((span, kvh, g), NEG_INF)
        for *_, m, _ in stats:
            mm = torch.maximum(mm, m)
        ll = torch.zeros_like(mm)
        for *_, m, l in stats:
            ll = ll + l * torch.exp(m - mm)
        p = (torch.exp(scores - mm[..., None]) / ll[..., None]).to(
            pool["v"].dtype).float()
        o = torch.zeros(span, kvh, g, d)
        for lo, hi, mask, _, l in stats:
            acc = torch.einsum("ckgt,tkd->ckgd",
                               torch.where(mask, p[..., lo:hi], 0.0),
                               cv[lo:hi])
            o = o + torch.where((l > 0)[..., None], acc, 0.0)
        out.append(o.to(q.dtype).reshape(span, h, d))
    return torch.stack(out)


def _paged_inputs(seed, span, g, splits, chunk, granule, kvh=2, d=8, bs=4,
                  nbl=14, dtype=torch.float32):
    """Lanes: 0 parked at position 0 on an all-null table; windows ending
    at C - 1, C and C + 1 for the host's chunk C (for span > 1, across
    the chunk boundary); one ending at the table's capacity; one whose
    live length is splits * granule + 1 (a lane's own chunk one granule
    up). Each live lane's table holds its own permuted blocks and
    null-block tails."""
    rng = np.random.RandomState(seed)
    cap = nbl * bs
    last = np.clip([chunk - 1, chunk, chunk + 1, cap - 1, splits * granule],
                   span - 1, cap - 1)
    pos = np.concatenate([[0], last - (span - 1)]).astype(np.int32)
    b = len(pos)
    nb = 1 + b * nbl
    pool = {n: torch.from_numpy(rng.randn(nb, bs, kvh, d).astype(np.float32))
            .to(dtype) for n in "kv"}
    tables = np.zeros((b, nbl), np.int32)
    for i in range(1, b):
        need = -(-(pos[i] + span) // bs)
        tables[i, :need] = 1 + i * nbl + rng.permutation(nbl)[:need]
    q = torch.from_numpy(rng.randn(b, span, kvh * g, d).astype(np.float32))
    return q.to(dtype), pool, torch.from_numpy(tables), torch.from_numpy(pos)


# (span, G, wanted splits, granule): granule None fixes every lane's chunk
# at the host's; 14 splits of one block leave more splits than live
# chunks; the granule is the block size, as the wrapper passes it
PAGED_CASES = [(1, 1, 1, None), (1, 2, 2, None), (3, 2, 7, None),
               (1, 1, 14, None), (1, 1, 2, 4), (3, 2, 7, 4), (1, 2, 14, 4)]


@pytest.mark.parametrize("span,g,want,granule", PAGED_CASES)
def test_paged_split_model_matches_jax_kernel_and_plain_fp32(span, g, want,
                                                             granule):
    """fp32 at 1e-5 against the JAX kernel and the plain version."""
    splits, chunk = _plan(56, want, multiple=4)
    granule = granule or chunk
    q, pool, tables, pos = _paged_inputs(span + 3 * want, span, g, splits,
                                         chunk, granule)
    got = paged_split_model(q, pool, tables, pos, splits, chunk, granule)
    want_j = np.asarray(jax_paged_attention(
        jnp.asarray(q.numpy()), {n: jnp.asarray(a.numpy())
                                 for n, a in pool.items()},
        jnp.asarray(tables.numpy()), jnp.asarray(pos.numpy()),
        interpret=True))
    want_p = kernels.paged_attention(q, pool, tables, pos)
    np.testing.assert_allclose(got.numpy(), want_j, **TOL_F32)
    np.testing.assert_allclose(got.numpy(), want_p.numpy(), **TOL_F32)


@pytest.mark.parametrize("span,g,want", [(1, 1, 1), (1, 2, 2), (3, 2, 7)])
def test_paged_split_model_bf16_within_the_card_gate(span, g, want):
    """bf16: the model rounds each probability to bf16 after the merged
    (m, l), as the kernel does, and meets the plain version and the JAX
    kernel on the same bf16 inputs at the card's bf16 gate."""
    splits, chunk = _plan(56, want, multiple=4)
    q, pool, tables, pos = _paged_inputs(20 + want, span, g, splits, chunk, 4,
                                         dtype=torch.bfloat16)
    got = paged_split_model(q, pool, tables, pos, splits, chunk, 4)
    assert got.dtype == torch.bfloat16
    want_p = kernels.paged_attention(q, pool, tables, pos)
    np.testing.assert_allclose(got.float().numpy(), want_p.float().numpy(),
                               **TOL_BF16)
    want_j = jax_paged_attention(
        jnp.asarray(q.float().numpy(), jnp.bfloat16),
        {n: jnp.asarray(a.float().numpy(), jnp.bfloat16)
         for n, a in pool.items()},
        jnp.asarray(tables.numpy()), jnp.asarray(pos.numpy()),
        interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want_j.astype(jnp.float32)),
                               **TOL_BF16)


def test_lane_chunk_covers_each_lane():
    """For every live length up to the capacity, a lane's chunks cover
    its live positions; its chunk is a multiple of the granule and at
    most the host's, and the least such chunk that covers them, so the
    lane spreads over the splits; with the granule at the host's chunk,
    every live lane takes that chunk."""
    for capacity, want, granule in ((4096, 16, 16), (4096, 16, 32),
                                    (56, 7, 4), (56, 14, 4), (64, 3, 64)):
        splits, chunk = _plan(capacity, want, granule)
        for live in range(capacity + 1):
            c = lane_chunk(live, splits, chunk, granule)
            assert c <= chunk and c % granule == 0
            assert splits * c >= live
            assert c == chunk or splits * (c - granule) < live
            assert lane_chunk(live, splits, chunk, chunk) == (
                chunk if live else 0)


def _squeeze(text):
    return " ".join(text.split())


def test_model_follows_the_kernel_source():
    """The lines of ``decode_attention.cu`` that the models copy:
    ``lane_chunk``'s body, the granule each kernel passes it (the block
    size in both paged passes of both paged modes, fp/bf16 and int8 (the
    int8 ones modelled in ``test_torch_int8_split.py``), kFlashGranule =
    FLASH_DECODE_GRANULE in flash decode), the span each split walks, and
    the split limit (kMaxSplits = DECODE_MAX_SPLITS)."""
    src = KERNEL_SOURCE.read_text()
    body = re.search(r"int lane_chunk\(int live, int splits, int chunk,"
                     r"\s*int granule\) \{(.*?)\n\}", src, re.S)
    assert body is not None
    assert _squeeze(body.group(1)) == (
        "const int even = (max(live, 0) + splits - 1) / splits; "
        "return min(chunk, (even + granule - 1) / granule * granule);")
    for name, want in (("kFlashGranule", torch_flash.FLASH_DECODE_GRANULE),
                       ("kMaxSplits", common.DECODE_MAX_SPLITS)):
        found = re.findall(r"constexpr int %s = (\d+);" % name, src)
        assert [int(v) for v in found] == [want], name
    calls = re.findall(r"const int lane_c = lane_chunk\(([^;]*)\);", src)
    assert sorted(_squeeze(c) for c in calls) == [
        "last + 1, gridDim.x, chunk, bs", "last + 1, gridDim.x, chunk, bs",
        "last + 1, splits, chunk, bs", "last + 1, splits, chunk, bs",
        "len, gridDim.x, chunk, kFlashGranule"]
    assert src.count("const int start = split * lane_c;") == 5
    assert sorted(_squeeze(e) for e in re.findall(
        r"const int end = (min\(start \+ lane_c, [^;]*\));", src)) == [
        "min(start + lane_c, last + 1)"] * 4 + ["min(start + lane_c, len)"]


# --------------------------------------------------------- the planner ---

@pytest.mark.parametrize("lanes,kvh,capacity,multiple", [
    (8, 8, 4096, 64), (32, 8, 4096, 16), (128, 8, 4096, 16), (1, 1, 1, 1),
    (8, 8, 256, 64), (3, 2, 56, 4), (1, 8, 131072, 16), (64, 16, 100, 1)])
def test_decode_splits_covers_the_capacity(lanes, kvh, capacity, multiple):
    """Python ints in and out; the chunks cover every position up to the
    capacity with none starting past it; a chunk is a multiple of
    ``multiple`` (B3 passes the block size) and no shorter than
    DECODE_MIN_CHUNK where the capacity allows; at most DECODE_MAX_SPLITS
    splits; a grid short of DECODE_CTAS could not take a chunk one
    ``multiple`` shorter without going under DECODE_MIN_CHUNK, over
    DECODE_MAX_SPLITS or past DECODE_CTAS."""
    splits, chunk = common.decode_splits(lanes, kvh, capacity, multiple)
    assert type(splits) is int and type(chunk) is int
    assert 1 <= splits <= common.DECODE_MAX_SPLITS and chunk % multiple == 0
    assert splits * chunk >= capacity > (splits - 1) * chunk
    assert chunk >= min(common.DECODE_MIN_CHUNK, capacity)
    shorter = chunk - multiple
    if lanes * kvh * splits < common.DECODE_CTAS and shorter > 0:
        more = -(-capacity // shorter)
        assert shorter < common.DECODE_MIN_CHUNK or \
            more > common.DECODE_MAX_SPLITS or \
            lanes * kvh * more >= common.DECODE_CTAS


def test_decode_splits_refuses_anything_but_host_ints():
    """A device value (a tensor length) or a float is refused, so no
    caller can make the plan depend on data on the card."""
    for bad in ((torch.tensor(8), 8, 4096), (8, 8, 4096.0), (8, 0, 4096)):
        with pytest.raises(TypeError, match="Python ints"):
            common.decode_splits(*bad)


def test_wrappers_plan_from_shapes():
    """The serving shapes' plans: B4 at 8 lanes x 8 heads x 4096 and B3
    on the served pool (32 lanes, 256-entry tables of 16 positions)."""
    b4 = common.decode_splits(8, 8, 4096, 64)
    b3 = common.decode_splits(32, 8, 256 * 16, 16)
    assert b4[1] % 64 == 0 and b3[1] % 16 == 0
    assert 8 * 8 * b4[0] >= 2 * common.SM_COUNT
    assert 32 * 8 * b3[0] >= 2 * common.SM_COUNT
