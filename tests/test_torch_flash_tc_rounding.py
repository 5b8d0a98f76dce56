"""The rounding of the tensor-core flash kernels (``flash_fwd_sm90`` in
``mxnet_tpu_torch/csrc/flash_fwd_sm90.cuh``: bf16 B1 and B5;
``flash_bwd_dq_sm90`` and ``flash_bwd_dkv_sm90`` in
``csrc/flash_bwd_sm90.cuh``: bf16 B2a and B2b) against the plain versions
they are held to on the card, on the CPU.

The CUDA template cannot run here, so ``emulate`` repeats its arithmetic
in plain torch: bf16 q, k and v whose products are exact in fp32; S = Q K^T
summed in fp32 and scaled by 1/sqrt(D) after the product; 64-key tiles
with an online (m, l) in fp32 (keys past Tk read as zero rows, as TMA
fills them, and score -inf; causal masked scores -1e30; tiles wholly past
the diagonal skipped); P split into P_hi = bf16(p) and P_lo =
bf16(p - P_hi), each tile's P_hi V + P_lo V summed alone and added to o in
fp32. Its outputs must hold the gates of ``chip_smoke.py`` unchanged:
``TOL_FLASH["bfloat16"]`` and ``TOL_LSE`` against
``dense_attention_with_lse``, and the fp32 ``TOL_FLASH`` pair against
``carry_block_reference`` on the rows the carry's contract specifies. A
single bf16 P (no P_lo) breaks the carry's gate, which is why the kernel
splits P.

``emulate_bwd`` does the same for the backward template: S and dP summed
in fp32 from bf16 operands, S scaled after the product, P = exp2(S scale
log2e - lse log2e) and dS = P (dP - delta) on 64-row tiles; keys past Tk
(dQ) and query columns past Tq (dK/dV) read as zero rows, as TMA fills
them, and get p = 0; causal masked scores p = 0, tiles wholly past the
diagonal skipped; P and dS split into bf16 hi + lo parts, and dQ, dK, dV
summed across tiles in fp32 in the kernels' tile order, dQ and dK scaled
by 1/sqrt(D) at the end. Its gradients must hold ``TOL_FLASH["bfloat16"]``
against ``dense_attention_bwd``; a single bf16 P and dS breaks that gate,
which is why the backward splits both.
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import kernels
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

TILE = 64
LOG2E = 1.4426950408889634


def _bf16(shape, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16)


def emulate(q, k, v, carry=None, q_offset=0, kv_offset=0, causal=True,
            split=True):
    """The kernel template's arithmetic over bf16 q [BH, Tq, D], k, v
    [BH, Tk, D]. With ``carry`` (o, m, l in fp32) it is B5 and returns
    the new carry; without, B1's (o in bf16, lse in fp32)."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    pad = -tk % TILE
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    qf = q.float()
    scale = 1.0 / math.sqrt(d)
    if carry is None:
        o = torch.zeros((bh, tq, d))
        m = torch.full((bh, tq), -1e30)
        l = torch.zeros((bh, tq))
    else:
        o, m, l = (t.clone() for t in carry)
    n_tiles = (tk + TILE - 1) // TILE
    for q0 in range(0, tq, TILE):
        rows = slice(q0, min(q0 + TILE, tq))
        n_kt = n_tiles
        if causal:
            reach = q_offset + q0 + TILE - 1 - kv_offset
            n_kt = 0 if reach < 0 else min(n_tiles, reach // TILE + 1)
        qpos = q_offset + torch.arange(q0, rows.stop)
        for kt in range(n_kt):
            cols = slice(kt * TILE, (kt + 1) * TILE)
            kc = torch.arange(kt * TILE, (kt + 1) * TILE)
            s = (qf[:, rows] @ kf[:, cols].transpose(1, 2)) * scale
            s = torch.where(kc >= tk, -math.inf, s)
            if causal:
                s = torch.where(qpos[:, None] < kv_offset + kc[None, :],
                                -1e30, s)
            m_old = m[:, rows]
            m_new = torch.maximum(m_old, s.amax(-1))
            alpha = torch.exp2((m_old - m_new) * LOG2E)
            p = torch.exp2((s - m_new[..., None]) * LOG2E)
            l[:, rows] = alpha * l[:, rows] + p.sum(-1)
            p_hi = p.to(torch.bfloat16).float()
            pv = p_hi @ vf[:, cols]
            if split:
                p_lo = (p - p_hi).to(torch.bfloat16).float()
                pv = pv + p_lo @ vf[:, cols]
            o[:, rows] = alpha[..., None] * o[:, rows] + pv
            m[:, rows] = m_new
    if carry is not None:
        return o, m, l
    ll = torch.clamp(l, min=1e-30)
    return (o / ll[..., None]).to(torch.bfloat16), m + torch.log(ll)


def _share(got, want, atol, rtol):
    """Worst |got - want| / (atol + rtol |want|): 1 is the gate."""
    want = want.float()
    return float(((got.float() - want).abs()
                  / (atol + rtol * want.abs())).max())


def _carry_share(got, want, carry, q_offset, kv_offset, causal):
    """The carry gate of chip_smoke.check_flash_carry: o, m and l at the
    fp32 pair, on the rows with a real key in the carry or an unmasked
    one in this step."""
    tq = carry[1].shape[1]
    rows = ((carry[1] > -1e29) | (not causal)
            | (q_offset + torch.arange(tq) >= kv_offset)[None])
    atol, rtol = cs.TOL_FLASH["float32"]
    share = 0.0
    for g, w in zip(got, want):
        sel = rows[..., None].expand_as(g) if g.dim() == 3 else rows
        share = max(share, _share(g[sel], w[sel], atol, rtol))
    return share


def _fresh(bh, tq, d):
    return (torch.zeros((bh, tq, d)), torch.full((bh, tq), -1e30),
            torch.zeros((bh, tq)))


FWD_CASES = [(8, 256, 256, 128, True), (8, 256, 256, 128, False),
             (8, 256, 256, 64, True), (8, 256, 256, 64, False),
             (6, 333, 200, 128, True), (6, 333, 200, 128, False)]


@pytest.mark.parametrize("bh, tq, tk, d, causal", FWD_CASES)
def test_forward_rounding_holds_the_bf16_gate(bh, tq, tk, d, causal):
    q, k, v = (_bf16((bh, t, d), seed) for seed, t in
               enumerate((tq, tk, tk)))
    o, lse = emulate(q, k, v, causal=causal)
    o_ref, lse_ref = kernels.dense_attention_with_lse(q, k, v, causal)
    assert o.dtype == o_ref.dtype == torch.bfloat16
    assert _share(o, o_ref, *cs.TOL_FLASH["bfloat16"]) <= 1.0
    assert float((lse - lse_ref).abs().max()) <= cs.TOL_LSE


CARRY_CASES = [
    # (bh, tq, tk, d, q_offset, kv_offset, causal, in flight)
    (8, 256, 256, 128, 0, 0, True, False),
    (8, 256, 256, 64, 0, 0, True, False),
    (8, 256, 256, 128, 0, 256, False, True),
    (8, 256, 256, 128, 1000, 520, True, True),
    (8, 256, 256, 64, 1000, 520, True, True),
    (6, 333, 200, 128, 200, 0, True, False),
]


def _carry_case(bh, tq, tk, d, q_offset, kv_offset, causal, flight):
    q, k, v = (_bf16((bh, t, d), 10 + seed) for seed, t in
               enumerate((tq, tk, tk)))
    carry = _fresh(bh, tq, d)
    if flight:
        # a ring's state: the kernel's fold of the q shard's own block
        k0, v0 = _bf16((bh, tq, d), 20), _bf16((bh, tq, d), 21)
        carry = emulate(q, k0, v0, carry, q_offset, q_offset, True)
    return q, k, v, carry


@pytest.mark.parametrize("bh, tq, tk, d, q_offset, kv_offset, causal, flight",
                         CARRY_CASES)
def test_carry_rounding_holds_the_fp32_gate(bh, tq, tk, d, q_offset,
                                            kv_offset, causal, flight):
    q, k, v, carry = _carry_case(bh, tq, tk, d, q_offset, kv_offset, causal,
                                 flight)
    got = emulate(q, k, v, carry, q_offset, kv_offset, causal)
    want = kernels.carry_block_reference(q, k, v, *carry, q_offset,
                                         kv_offset, causal)
    assert _carry_share(got, want, carry, q_offset, kv_offset,
                        causal) <= 1.0


def test_dead_carry_step_returns_the_carry():
    q, k, v, carry = _carry_case(4, 128, 128, 64, 1024, 2048, True, True)
    got = emulate(q, k, v, carry, 1024, 2048, True)
    assert all(torch.equal(g, c) for g, c in zip(got, carry))


@pytest.mark.parametrize("q_offset, kv_offset", [(0, 0), (1000, 520)])
def test_a_single_bf16_p_breaks_the_carry_gate(q_offset, kv_offset):
    """Why P is split: with P rounded to bf16 once before PV, the carry's
    o is off by ~2^-9 of each p v term, far beyond the fp32 pair."""
    case = (8, 256, 256, 128, q_offset, kv_offset, True, q_offset > 0)
    q, k, v, carry = _carry_case(*case)
    got = emulate(q, k, v, carry, q_offset, kv_offset, True, split=False)
    want = kernels.carry_block_reference(q, k, v, *carry, q_offset,
                                         kv_offset, True)
    assert _carry_share(got, want, carry, q_offset, kv_offset, True) > 10.0


# ------------------------------------------------------------- backward ---

def _pad_rows(x, rows, fill):
    """x [BH, T, ...] padded to ``rows`` rows with ``fill`` (a tensor of
    the padded shape), or zeros, as TMA fills the rows past T."""
    pad = torch.zeros((x.shape[0], rows - x.shape[1]) + tuple(x.shape[2:]))
    if fill is not None:
        pad = fill(pad.shape)
    return torch.cat([x.float(), pad], 1)


def emulate_bwd(q, k, v, do, lse, delta, causal=True, split=True,
                junk=None):
    """The backward template's arithmetic over bf16 q, do [BH, Tq, D],
    k, v [BH, Tk, D] with the fp32 lse and delta [BH, Tq]: (dq, dk, dv)
    in bf16. ``junk(shape)``, if given, fills the rows past Tq and Tk (and
    their lse and delta) instead of the zeros the kernels read there,
    to show that the mask, not the data, keeps them out."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    nq, nk = -(-tq // TILE), -(-tk // TILE)
    qf, dof = (_pad_rows(x, nq * TILE, junk) for x in (q, do))
    kf, vf = (_pad_rows(x, nk * TILE, junk) for x in (k, v))
    lse2, dl = (_pad_rows(x[..., None], nq * TILE, junk)[..., 0]
                for x in (lse * LOG2E, delta))
    sl = 1.0 / math.sqrt(d) * LOG2E
    qpos, kpos = torch.arange(nq * TILE), torch.arange(nk * TILE)

    def parts(x):
        hi = x.to(torch.bfloat16).float()
        if not split:
            return (hi,)
        return hi, (x - hi).to(torch.bfloat16).float()

    def tile_p_ds(qs, ks, s, dp):
        """P and dS of the score tile s [BH, queries qs, keys ks]."""
        live = (qpos[qs, None] < tq) & (kpos[None, ks] < tk)
        if causal:
            live &= qpos[qs, None] >= kpos[None, ks]
        p = torch.where(live, torch.exp2(s * sl - lse2[:, qs, None]), 0.0)
        return p, p * (dp - dl[:, qs, None])

    dq = torch.zeros((bh, nq * TILE, d))
    for qt in range(nq):
        qs = slice(qt * TILE, (qt + 1) * TILE)
        for kt in range(min(nk, qt + 1) if causal else nk):
            ks = slice(kt * TILE, (kt + 1) * TILE)
            _, ds = tile_p_ds(qs, ks, qf[:, qs] @ kf[:, ks].transpose(1, 2),
                              dof[:, qs] @ vf[:, ks].transpose(1, 2))
            for part in parts(ds):
                dq[:, qs] += part @ kf[:, ks]
    dk = torch.zeros((bh, nk * TILE, d))
    dv = torch.zeros((bh, nk * TILE, d))
    for kt in range(nk):
        ks = slice(kt * TILE, (kt + 1) * TILE)
        for qt in range(kt if causal else 0, nq):
            qs = slice(qt * TILE, (qt + 1) * TILE)
            # the transposed frame of the kernel: P^T, dS^T [BH, keys, queries]
            pt, dst = (x.transpose(1, 2) for x in tile_p_ds(
                qs, ks, (kf[:, ks] @ qf[:, qs].transpose(1, 2)).transpose(1, 2),
                (vf[:, ks] @ dof[:, qs].transpose(1, 2)).transpose(1, 2)))
            for part in parts(pt):
                dv[:, ks] += part @ dof[:, qs]
            for part in parts(dst):
                dk[:, ks] += part @ qf[:, qs]
    scale = 1.0 / math.sqrt(d)
    return ((scale * dq[:, :tq]).to(torch.bfloat16),
            (scale * dk[:, :tk]).to(torch.bfloat16),
            dv[:, :tk].to(torch.bfloat16))


def _bwd_case(bh, tq, tk, d, causal):
    """Seeded bf16 q, k, v, do, the plain forward's (o, lse) and the
    wrapper's delta = rowsum(dO O) in fp32, as chip_smoke's checks."""
    q, k, v, do = (_bf16((bh, t, d), 40 + seed) for seed, t in
                   enumerate((tq, tk, tk, tq)))
    o, lse = kernels.dense_attention_with_lse(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1)
    return q, k, v, do, o, lse, delta


def _bwd_shares(bh, tq, tk, d, causal, split):
    q, k, v, do, o, lse, delta = _bwd_case(bh, tq, tk, d, causal)
    got = emulate_bwd(q, k, v, do, lse, delta, causal, split)
    want = kernels.dense_attention_bwd(q, k, v, o, lse, do, causal)
    return [_share(g, w, *cs.TOL_FLASH["bfloat16"])
            for g, w in zip(got, want)]


BWD_CASES = [(2, 1024, 1024, 128, True), (2, 1024, 1024, 128, False),
             (2, 1024, 1024, 64, True), (2, 1024, 1024, 64, False),
             (6, 333, 200, 128, True), (6, 333, 200, 128, False)]


@pytest.mark.parametrize("bh, tq, tk, d, causal", BWD_CASES)
def test_backward_rounding_holds_the_bf16_gate(bh, tq, tk, d, causal):
    """dq, dk and dv of the split template against dense_attention_bwd
    at chip_smoke's bf16 TOL_FLASH."""
    assert max(_bwd_shares(bh, tq, tk, d, causal, split=True)) <= 1.0


@pytest.mark.parametrize("d", [128, 64])
def test_a_single_bf16_p_and_ds_breaks_the_bf16_gate(d):
    """Why the backward splits P and dS: with each rounded to one bf16
    operand before its product, every gradient misses the bf16 gate by a
    clear margin."""
    shares = _bwd_shares(2, 1024, 1024, d, True, split=False)
    assert min(shares) > 1.5, shares


@pytest.mark.parametrize("causal", [True, False])
def test_padded_rows_of_a_ragged_tile_add_nothing(causal):
    """The query columns past Tq of a dK/dV tile (and the keys past Tk of
    a dQ tile) get p = 0 from the mask, so whatever those rows hold, even
    values whose exp(S - lse) overflows, the gradients are the same."""
    q, k, v, do, _, lse, delta = _bwd_case(6, 333, 200, 128, causal)
    gen = torch.Generator().manual_seed(7)

    def junk(shape):
        return 1e4 * torch.randn(shape, generator=gen)

    zero = emulate_bwd(q, k, v, do, lse, delta, causal)
    filled = emulate_bwd(q, k, v, do, lse, delta, causal, junk=junk)
    for a, b in zip(zero, filled):
        assert torch.isfinite(a.float()).all()
        assert torch.equal(a, b)
