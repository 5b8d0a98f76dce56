"""The rounding of the tensor-core flash kernels (``flash_fwd_sm90`` in
``mxnet_tpu_torch/csrc/flash_fwd_sm90.cuh``: bf16 B1 and B5) against the
plain versions they are held to on the card, on the CPU.

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
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import kernels

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
