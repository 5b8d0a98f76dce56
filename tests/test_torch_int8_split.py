"""The split-K arithmetic of B3's int8 mode (``paged_decode_int8``),
modelled in PyTorch on the CPU.

The CUDA kernels of ``csrc/decode_attention.cu`` split each lane's
positions into chunks, as the fp32/bf16 mode does. Pass 1 quantises each
packed q row, writes every score ((s * qs) * ks / sqrt(D) of the exact
integer dot) and each chunk's (m, l, amax), amax being the largest
exp(s - m) * vs; pass 2 merges every split's statistics in split order,
carrying each amax to the row's max, forms the probability scale as and
the codes rint(a * vs / as) of a = exp(s - m) / l from the stored scores,
and writes its chunk's integer sums; the combine adds the splits' sums
(integers, exact) and scales them by as. The model below follows those
steps split by split, with the integer sums in int64, and is held
against the JAX package's Pallas kernel (interpret mode, as
``tests/test_torch_kv_int8.py`` runs it) and against the port's plain
version, which is what the wrapper runs on the CPU, at the card's int8
gate: ``chip_smoke.py``'s TOL plus one probability code, the code needed
by at most 1% of the elements. ``chip_smoke.py`` holds the kernels
themselves against the same plain version on the GPU.

The model copies the kernels' split rule and must be kept in step with
``csrc/decode_attention.cu``: ``test_model_follows_the_kernel_source``
pins the lines it copies, so an edit to the int8 kernels' split rule
fails here until the model follows it.
"""

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

KERNEL_SOURCE = (Path(common.__file__).resolve().parent.parent / "csrc"
                 / "decode_attention.cu")
NEG_INF = common.NEG_INF
# chip_smoke.py's gate for the int8 mode: TOL (atol, rtol) plus one
# probability code of the row, the code needed by at most CODE_SHARE of
# the elements
TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-3, 2.0 ** -7)}
CODE_SHARE = 0.01


def lane_chunk(live, splits, chunk, granule):
    """The kernels' ``lane_chunk``: a lane's live length over the splits,
    rounded up to ``granule``, at most the host's ``chunk``."""
    even = -(-max(live, 0) // splits)
    return min(chunk, -(-even // granule) * granule)


def _plan(capacity, splits, bs):
    """(splits, chunk) for a wanted split count: chunk a multiple of the
    block size covering [0, capacity), as ``decode_splits`` makes it."""
    chunk = -(-capacity // splits)
    chunk = -(-chunk // bs) * bs
    return -(-capacity // chunk), chunk


def int8_split_model(q, pool, tables, pos, splits, chunk):
    """B3's int8 passes lane by lane. Returns (out [B, span, H, D] in
    q.dtype, the (lane, split, window row) triples of live splits in
    which a row attends nothing). The granule of a lane's chunk is the
    block size."""
    b, span, h, d = q.shape
    bs, kvh = pool["k"].shape[1], pool["k"].shape[2]
    g = h // kvh
    cap = tables.shape[1] * bs
    sqrt_d = torch.tensor(math.sqrt(d), dtype=torch.float32)
    out, idle = [], []
    for lane in range(b):
        idx = tables[lane].long()
        kq, vq = (pool[n][idx].reshape(cap, kvh, d) for n in "kv")
        ks, vs = (pool[n][idx].reshape(cap, kvh).T for n in ("ks", "vs"))
        # pass 1: q codes per packed row, then every score, in fp32
        q8, qs = common.kv_quant(q[lane].reshape(span, kvh, g, d))
        si = torch.einsum("ckgd,tkd->ckgt", q8.double(), kq.double())
        scores = si.float() * qs[..., None] * ks[None, :, None, :] / sqrt_d
        p0 = int(pos[lane])
        last = min(p0 + span - 1, cap - 1)
        c = lane_chunk(last + 1, splits, chunk, bs)
        attend = (torch.arange(cap)[None, :]
                  <= p0 + torch.arange(span)[:, None])[:, None, None, :]
        stats = []
        for s in range(splits):
            lo, hi = s * c, min((s + 1) * c, last + 1)
            if lo >= hi:        # an empty split: (m, l, amax) = (-1e30, 0, 0)
                continue
            mask = attend[..., lo:hi]
            sc = torch.where(mask, scores[..., lo:hi], NEG_INF)
            m = sc.amax(-1)
            p = torch.where(mask, torch.exp(sc - m[..., None]), 0.0)
            amax = (p * vs[None, :, None, lo:hi]).amax(-1)
            stats.append((lo, hi, mask, m, p.sum(-1), amax))
            idle += [(lane, s, cc) for cc in range(span)
                     if not bool(mask[cc].any())]
        # pass 2: the split-order merge, each amax carried to the max
        mm = torch.full((span, kvh, g), NEG_INF)
        for *_, m, _, _ in stats:
            mm = torch.maximum(mm, m)
        ll, aa = torch.zeros_like(mm), torch.zeros_like(mm)
        for *_, m, l, amax in stats:
            w = torch.exp(m - mm)
            ll = ll + l * w
            aa = torch.maximum(aa, amax * w)
        as_ = torch.clamp(aa / ll, min=1e-8) / torch.tensor(127.0)
        a = torch.exp(scores - mm[..., None]) / ll[..., None]
        codes = torch.round(a * vs[None, :, None, :] / as_[..., None]) \
            .clamp(-127, 127).long()
        # each split's int32 sums (int64 here), then the combine
        total = torch.zeros(span, kvh, g, d, dtype=torch.long)
        for lo, hi, mask, _, l, _ in stats:
            part = torch.einsum("ckgt,tkd->ckgd",
                                torch.where(mask, codes[..., lo:hi], 0),
                                vq[lo:hi].long())
            total = total + torch.where((l > 0)[..., None], part, 0)
        out.append((total.float() * as_[..., None]).to(q.dtype)
                   .reshape(span, h, d))
    return torch.stack(out), idle


def code_step(q, pool, tables, pos):
    """127 * as of every output row of the plain version, [B, span, H, 1]:
    one probability code moves an element of its row by at most as *
    |v code| <= 127 * as (chip_smoke.int8_code_step's rule)."""
    b, span, h, d = q.shape
    bs, kvh = pool["k"].shape[1:3]
    idx = tables.long()
    t = tables.shape[1] * bs
    kq = pool["k"][idx].reshape(b, t, kvh, d)
    ks, vs = (pool[n][idx].reshape(b, t, kvh).transpose(1, 2)
              [:, None, :, None, :] for n in ("ks", "vs"))
    q8, qs = common.kv_quant(q.reshape(b, span, kvh, h // kvh, d))
    s = torch.einsum("bckgd,btkd->bckgt", q8.double(), kq.double()).float()
    s = s * qs[..., None] * ks / math.sqrt(d)
    positions = pos.long()[:, None] + torch.arange(span)
    mask = torch.arange(t) <= positions[:, :, None]
    a = torch.softmax(torch.where(mask[:, :, None, None, :], s, NEG_INF), -1)
    as_ = (a * vs).amax(dim=-1).clamp_min(1e-8) / 127
    return (127 * as_).reshape(b, span, h, 1)


def assert_int8_gate(got, want, step, dtype):
    """Every element within TOL plus one code of its row, at most
    CODE_SHARE of them beyond TOL alone."""
    atol, rtol = TOL[dtype]
    got, want = got.float(), torch.as_tensor(want).float()
    err = (got - want).abs()
    base = atol + rtol * want.abs()
    assert float((err / (base + step)).max()) <= 1.0
    assert float((err > base).float().mean()) <= CODE_SHARE


def _inputs(seed, span, g, splits, chunk, kvh=2, d=16, bs=4, nbl=14,
            dtype=torch.float32):
    """q, an int8 pool (codes and scales of seeded rows) and lanes on the
    plan's edges: lane 0 parked at position 0 on an all-null table;
    windows ending at C - 1, C and C + 1 for the host's chunk C; one over
    2C - 2 .. 2C + span - 3 (across a chunk boundary for span > 2); one
    ending at the table's capacity; one whose live length is splits * bs
    + 1 (a lane's own chunk one block up). Each live lane's table holds
    its own permuted blocks and null-block tails."""
    rng = np.random.RandomState(seed)
    cap = nbl * bs
    last = np.clip([chunk - 1, chunk, chunk + 1, 2 * chunk + span - 3,
                    cap - 1, splits * bs], span - 1, cap - 1)
    pos = np.concatenate([[0], last - (span - 1)]).astype(np.int32)
    b = len(pos)
    nb = 1 + b * nbl
    pool = {}
    for n in "kv":
        rows = torch.from_numpy(rng.randn(nb, bs, kvh, d).astype(np.float32))
        pool[n], pool[n + "s"] = common.kv_quant(rows)
    tables = np.zeros((b, nbl), np.int32)
    for i in range(1, b):
        need = -(-(pos[i] + span) // bs)
        tables[i, :need] = 1 + i * nbl + rng.permutation(nbl)[:need]
    q = torch.from_numpy(rng.randn(b, span, kvh * g, d).astype(np.float32))
    return q.to(dtype), pool, torch.from_numpy(tables), torch.from_numpy(pos)


def _jax(q, pool, tables, pos):
    """The JAX package's Pallas kernel in interpret mode, one grid step
    over the whole table (block_k = capacity), q in its own dtype."""
    jq = jnp.asarray(q.float().numpy(),
                     jnp.bfloat16 if q.dtype == torch.bfloat16 else None)
    out = jax_paged_attention(
        jq, {n: jnp.asarray(a.numpy()) for n, a in pool.items()},
        jnp.asarray(tables.numpy()), jnp.asarray(pos.numpy()),
        block_k=tables.shape[1] * pool["k"].shape[1], interpret=True)
    return np.array(out.astype(jnp.float32))


# (span, G, wanted splits, q dtype): 2 and 5 splits of whole blocks, and
# 14 splits of one block, more splits than most lanes have live chunks
CASES = [(1, 1, 2, torch.float32), (4, 1, 5, torch.float32),
         (1, 4, 5, torch.float32), (4, 4, 14, torch.float32),
         (1, 1, 14, torch.bfloat16), (4, 4, 5, torch.bfloat16)]


@pytest.mark.parametrize("span,g,want,dtype", CASES)
def test_int8_split_model_meets_jax_kernel_and_plain(span, g, want, dtype):
    """The model against the JAX kernel and the plain version on the
    same inputs, at the card's int8 gate; the parked lane gives 0; with a
    span of 4 some live split attends nothing of some row."""
    splits, chunk = _plan(56, want, 4)
    q, pool, tables, pos = _inputs(7 * want + span + g, span, g, splits,
                                   chunk, dtype=dtype)
    got, idle = int8_split_model(q, pool, tables, pos, splits, chunk)
    assert got.dtype == dtype and got.shape == q.shape
    plain = kernels.paged_attention(q, pool, tables, pos)
    step = code_step(q, pool, tables, pos)
    assert_int8_gate(got, plain, step, dtype)
    assert_int8_gate(got, _jax(q, pool, tables, pos), step, dtype)
    # lane 0 attends position 0 of the null block, whose codes are the
    # quantised rows of block 0: it is a lane like the others
    assert torch.isfinite(got.float()).all()
    if span > 1:
        assert idle, "no live split without an attended position"


def test_int8_split_model_is_the_plain_version_on_one_split():
    """With one split the merge is the identity, so the model differs
    from the plain version only in the softmax's sum order: by at most
    one probability code of a row."""
    splits, chunk = _plan(56, 1, 4)
    q, pool, tables, pos = _inputs(3, 1, 2, splits, chunk)
    got, idle = int8_split_model(q, pool, tables, pos, splits, chunk)
    assert splits == 1 and not idle
    plain = kernels.paged_attention(q, pool, tables, pos)
    err = (got - plain).abs()
    assert bool((err <= 1e-6 + code_step(q, pool, tables, pos)).all())


def test_int8_sums_stay_exact_past_fp32():
    """Saturated codes over 2048 positions in 8 splits: each split's sum
    and the combined one pass 2^24, where fp32 would round; the combine
    in integers gives the exact total times as, as the plain version
    (float64 dots) does."""
    bs, nbl, kvh, d = 16, 128, 1, 8
    pool = {"k": torch.full((nbl + 1, bs, kvh, d), 127, dtype=torch.int8),
            "v": torch.from_numpy(np.random.RandomState(5).randint(
                100, 128, (nbl + 1, bs, kvh, d)).astype(np.int8)),
            "ks": torch.ones(nbl + 1, bs, kvh),
            "vs": torch.ones(nbl + 1, bs, kvh)}
    tables = torch.arange(1, nbl + 1, dtype=torch.int32)[None]
    pos = torch.tensor([nbl * bs - 1], dtype=torch.int32)
    q = torch.full((1, 1, kvh, d), 0.5)
    splits, chunk = _plan(nbl * bs, 8, bs)
    got, _ = int8_split_model(q, pool, tables, pos, splits, chunk)
    plain = kernels.paged_attention(q, pool, tables, pos)
    exact = 127 * pool["v"][1:].long().sum(dim=(0, 1))
    assert int(exact.min()) > 2 ** 24
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    as_ = np.float32(1 / (nbl * bs)) / np.float32(127)
    np.testing.assert_array_equal(got.reshape(-1).numpy(),
                                  exact.reshape(-1).numpy().astype(
                                      np.float32) * as_)


def _squeeze(text):
    return " ".join(text.split())


def _body(src, name):
    """The source of kernel ``name`` up to the next kernel's comment."""
    start = src.index(name + "(")
    return src[start:src.index("\n// ", start)]


def test_model_follows_the_kernel_source():
    """The lines of ``decode_attention.cu`` the model copies: in both
    int8 passes, the lane chunk (the block size as the granule) and the
    span of split s; the q scale; in pass 1 the score's op order and the
    online (m, l, amax) over the attended positions; pass 2's split-order
    merge with amax carried to the max and the code; the combine adding
    the splits whose l > 0."""
    src = KERNEL_SOURCE.read_text()
    scores = _squeeze(_body(src, "paged_int8_scores_kernel"))
    pv = _squeeze(_body(src, "paged_int8_pv_kernel"))
    combine = _squeeze(_body(src, "paged_int8_combine_kernel"))
    for body, splits in ((scores, "gridDim.x"), (pv, "splits")):
        assert ("const int lane_c = lane_chunk(last + 1, %s, chunk, bs); "
                "const int start = split * lane_c; "
                "const int end = min(start + lane_c, last + 1);" % splits
                ) in body
    for line in ("const float s = (float)si[r] * qs[r] * k_scale / sqrt_d;",
                 "if (t <= p0 + r / g) online_add(s, v_scale, m[r], l[r], "
                 "amax[r]);"):
        assert line in scores, line
    assert "const float scale = fmaxf(amax, 1e-8f) / 127.0f;" in _squeeze(
        src)
    online = _squeeze(re.search(
        r"void online_add\(.*?\n\}", src, re.S).group(0))
    for line in ("if (s > m) { const float alpha = expf(m - s); "
                 "l = l * alpha + 1.f; amax = fmaxf(amax * alpha, vs); "
                 "m = s; } else { const float p = expf(s - m); l += p; "
                 "amax = fmaxf(amax, p * vs); }",):
        assert line in online, line
    merge = _squeeze(re.search(
        r"void merge_int8_stats\(.*?\n\}", src, re.S).group(0))
    for line in ("mm = fmaxf(mm, m_r[s]);",
                 "const float w = expf(m_r[s] - mm); ll += l_r[s] * w; "
                 "aa = fmaxf(aa, a_r[s] * w);",
                 "as = fmaxf(aa / ll, 1e-8f) / 127.0f;"):
        assert line in merge, line
    for line in ("if (t < end && t <= p0 + r / g) {",
                 "- m_g[r]) / l_g[r];",
                 "c = quant_code(a * vs_s[slot * kTile + i_slot] / as_g[r]);"):
        assert line in pv, line
    for line in ("o += l_r[s] > 0.f ? a : 0;",
                 "from_float<T>((float)o * as_s[r]);"):
        assert line in combine, line


def test_int8_plan_is_the_paged_plan():
    """The int8 mode runs on the fp32/bf16 mode's plan: the wrapper asks
    ``paged_decode_splits`` for both, and the served pool's plan is 9
    splits of 464 positions."""
    assert kernels.paged_decode_splits(32, 8, 256, 16) == (9, 464)
    assert kernels.paged_decode_splits(8, 8, 256, 16) == (16, 256)
    assert kernels.paged_decode_splits(128, 8, 256, 16) == (3, 1376)
