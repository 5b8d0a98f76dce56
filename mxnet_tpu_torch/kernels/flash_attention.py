"""Flash attention for training and decode (port of
``mxnet_tpu/kernels/flash_attention.py``).

Training: ``flash_attention(q, k, v, causal)`` over [B, T, H, D] is a
``torch.autograd.Function`` (``_FlashAttention``) whose forward and
backward are the kernels of ``csrc/flash_attention.cu`` on CUDA tensors:

- ``flash_fwd`` replaces ``_fwd_kernel``: one CTA per (bh, 64-row query
  tile) streams the key tiles with an online (o, m, l) and writes o and
  the fp32 row lse;
- ``flash_bwd_dq`` replaces ``_dq_kernel`` (one CTA per query tile) and
  ``flash_bwd_dkv`` replaces ``_dkv_kernel`` (one CTA per key tile); both
  recompute P = exp(S - lse) from the saved lse, with
  delta = rowsum(dO * O) computed here, outside the kernels, as the JAX
  package computes it.

The autograd function saves (q, k, v, o, lse) as ``_flash_bh_fwd`` does.
Causal masking is top-left aligned (query i attends key j iff i >= j);
any Tq and Tk are taken. The kernels take float32 and bfloat16 at head
dims 64 and 128; anything else raises. Two routes by dtype: bfloat16
runs the tensor-core templates (TMA loads, wgmma with fp32 accumulation,
S scaled after the product): ``flash_fwd`` and ``flash_carry`` run
``csrc/flash_fwd_sm90.cuh`` (P split into two bf16 parts for PV),
``flash_bwd_dq`` and ``flash_bwd_dkv`` run ``csrc/flash_bwd_sm90.cuh``
(P and dS split into two bf16 parts each, dQ, dK and dV summed in the
tensor cores' accumulators); float32 runs CUDA-core kernels that dot in
fp32.
``dense_attention_with_lse`` and ``dense_attention_bwd`` are the plain
versions, and what CPU tensors run: the same formulas by plain tensor
ops (q pre-scaled in fp32, every dot in fp32, masked scores at the
finite -1e30).

Decode: ``flash_decode`` / ``flash_decode_with_lse`` launch the
``flash_decode`` kernels of ``csrc/decode_attention.cu`` on CUDA tensors.
They replace the TPU kernel ``_decode_kernel``. Their bound is the live
K/V bytes (about G flops per byte of bf16 cache), and a serving batch
has too few (lane, KV head) pairs to keep those bytes in flight on 132
SMs, so the work is split over the sequence as well: a grid of (splits,
KVH, B) CTAs, each streaming one chunk of its lane's first
``lengths[b]`` cache rows once for all G query heads of the group (q
pre-scaled by 1/sqrt(D) in fp32, a single-pass online softmax) into an
fp32 (m, l, acc) partial; a second kernel merges the splits in a fixed
order into (o, lse). The split count comes from the shapes alone
(``common.decode_splits``), never from ``lengths``, so a decode step
reads nothing back from the card; each CTA sizes its lane's chunk from
the length it reads (the length over the splits, rounded up to
FLASH_DECODE_GRANULE), so a short lane spreads over the splits too. ``dense_decode_with_lse`` is the plain
version: the same contract by plain tensor ops, PV accumulated in fp32.

Ring attention: ``flash_carry_block`` launches the ``flash_carry`` kernel
of ``csrc/flash_attention.cu`` on CUDA tensors. It replaces the TPU
kernel ``_carry_kernel`` (reached via the JAX ``flash_carry_block``): one
ring step folds a K/V shard into an unnormalised fp32 (o, m, l) carry,
with the causal mask at global positions. ``carry_block_reference`` is
its plain version, with the fp32 kernel's arithmetic (q pre-scaled in
fp32, masked scores at the finite -1e30), which the bf16 tensor-core
route meets at the fp32 tolerance. It is forward-only, as in JAX.
"""

import math

import torch

from . import _build
from .common import (DTYPE_CODE, NEG_INF, check_cuda_inputs, decode_splits,
                     lane_ints)

__all__ = ["flash_attention", "flash_attention_with_lse",
           "flash_attention_bwd", "flash_bwd_dq", "flash_bwd_dkv",
           "dense_attention_with_lse", "dense_attention_bwd",
           "flash_decode", "flash_decode_with_lse", "dense_decode_with_lse",
           "flash_decode_splits",
           "flash_carry_block", "carry_block_reference"]

FLASH_HEAD_DIMS = (64, 128)     # head dims the training kernels are built for
# a flash-decode split's largest chunk is a multiple of this many
# positions, and the chunk a CTA takes for its lane a multiple of the
# granule (the kernel's kFlashGranule), so every warp step of a walk is
# whole but a lane's last
FLASH_DECODE_MULTIPLE = 64
FLASH_DECODE_GRANULE = 32


# ----------------------------------------------------------- training ---

def _acc_dtype(x):
    """The plain versions compute in fp32, or in float64 for float64
    inputs (the gradient check)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _scores(q, k, causal):
    """(q pre-scaled by 1/sqrt(D), the masked scores q k^T) in the
    accumulation dtype, for [BH, Tq, D] / [BH, Tk, D]."""
    acc = _acc_dtype(q)
    qs = q.to(acc) * (1.0 / math.sqrt(q.shape[-1]))
    s = qs @ k.to(acc).transpose(1, 2)
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        mask = (torch.arange(tq, device=q.device)[:, None]
                >= torch.arange(tk, device=q.device)[None, :])
        s = torch.where(mask, s, NEG_INF)
    return qs, s


def dense_attention_with_lse(q, k, v, causal=False):
    """(o [BH, Tq, D] in q.dtype, lse [BH, Tq] fp32) by plain tensor ops
    — the contract of the ``flash_fwd`` kernel: softmax(q k^T / sqrt(D))
    v with o = acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30))."""
    _, s = _scores(q, k, causal)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    o = (p @ v.to(s.dtype)) / l[..., None]
    return o.to(q.dtype), m + torch.log(l)


def dense_attention_bwd(q, k, v, o, lse, do, causal=False):
    """(dq, dk, dv) by plain tensor ops — the contract of the
    ``flash_bwd_dq`` and ``flash_bwd_dkv`` kernels, by the JAX backward's
    formulas: P = exp(S - lse) with S from the pre-scaled q, delta =
    rowsum(dO * O) from the saved o, dS = P (dO V^T - delta),
    dQ = scale dS K, dK = dS^T (scale q), dV = P^T dO."""
    qs, s = _scores(q, k, causal)
    acc = s.dtype
    p = torch.exp(s - lse.to(acc)[..., None])
    dof = do.to(acc)
    delta = (dof * o.to(acc)).sum(dim=-1)
    ds = p * (dof @ v.to(acc).transpose(1, 2) - delta[..., None])
    dq = (1.0 / math.sqrt(q.shape[-1])) * (ds @ k.to(acc))
    dk = ds.transpose(1, 2) @ qs
    dv = p.transpose(1, 2) @ dof
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_flash_inputs(tensors, stats=()):
    """Validate what a training kernel is handed: [BH, T, D] tensors of
    one dtype (float32 or bfloat16) and head dim (64 or 128), contiguous,
    16-byte aligned and on one CUDA device, and float32 [BH, Tq] row
    statistics beside them."""
    q = tensors[0]
    if q.dtype not in DTYPE_CODE:
        raise TypeError("the flash kernels take float32 or bfloat16, not %s"
                        % q.dtype)
    if q.dim() != 3 or q.shape[-1] not in FLASH_HEAD_DIMS:
        raise ValueError("the flash kernels take [BH, T, D] tensors with D "
                         "in %s, not %s" % (FLASH_HEAD_DIMS, tuple(q.shape)))
    if q.device.type != "cuda":
        raise ValueError("the flash kernels run on a CUDA device, not %s"
                         % q.device)
    for t in tuple(tensors) + tuple(stats):
        if t.device != q.device:
            raise ValueError("all tensors must be on %s (got %s)"
                             % (q.device, t.device))
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the flash kernels take contiguous, 16-byte "
                             "aligned tensors")
    for t in tensors:
        if t.dtype != q.dtype:
            raise TypeError("q, k, v and the gradients must share one dtype "
                            "(%s vs %s)" % (q.dtype, t.dtype))
    for t in stats:
        if t.dtype != torch.float32 or t.shape != q.shape[:2]:
            raise ValueError("row statistics must be float32 [BH, Tq]")


def _check_qkv(q, k, v):
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError("q must be [BH, Tq, D] and k, v [BH, Tk, D], not "
                         "%s / %s / %s" % (tuple(q.shape), tuple(k.shape),
                                           tuple(v.shape)))
    if q.shape[1] < 1 or k.shape[1] < 1:
        raise ValueError("empty sequence")


def _scale(q):
    return 1.0 / math.sqrt(q.shape[-1])


def flash_attention_with_lse(q, k, v, causal=False):
    """Attention of q [BH, Tq, D] over k, v [BH, Tk, D]: (o [BH, Tq, D]
    in q.dtype, lse [BH, Tq] fp32). Launches ``flash_fwd`` on CUDA
    tensors; CPU tensors take :func:`dense_attention_with_lse`."""
    _check_qkv(q, k, v)
    if q.device.type == "cpu":
        return dense_attention_with_lse(q, k, v, causal)
    _check_flash_inputs((q, k, v))
    bh, tq, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    status = _build.load("flash_attention").flash_fwd(
        DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), bh, tq, k.shape[1], d, int(causal),
        _scale(q), _build.current_stream_ptr(q.device))
    _build.check(status, "flash_fwd")
    _build.launches["flash_fwd"] += 1
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, causal=False):
    """dq in q.dtype from the ``flash_bwd_dq`` kernel (CUDA tensors
    only): lse and delta are fp32 [BH, Tq]. bfloat16 runs the tensor-core
    kernel ``flash_bwd_dq_sm90``, float32 the CUDA-core kernel."""
    _check_qkv(q, k, v)
    _check_flash_inputs((q, k, v, do), (lse, delta))
    bh, tq, d = q.shape
    dq = torch.empty_like(q)
    status = _build.load("flash_attention").flash_bwd_dq(
        DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh,
        tq, k.shape[1], d, int(causal), _scale(q),
        _build.current_stream_ptr(q.device))
    _build.check(status, "flash_bwd_dq")
    _build.launches["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal=False):
    """(dk, dv) in k.dtype from the ``flash_bwd_dkv`` kernel (CUDA
    tensors only). bfloat16 runs the tensor-core kernel
    ``flash_bwd_dkv_sm90``, float32 the CUDA-core kernel."""
    _check_qkv(q, k, v)
    _check_flash_inputs((q, k, v, do), (lse, delta))
    bh, tq, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    status = _build.load("flash_attention").flash_bwd_dkv(
        DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), bh, tq, k.shape[1], d, int(causal), _scale(q),
        _build.current_stream_ptr(q.device))
    _build.check(status, "flash_bwd_dkv")
    _build.launches["flash_bwd_dkv"] += 1
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, causal=False):
    """(dq, dk, dv) of :func:`flash_attention_with_lse` given the saved
    (o, lse) and the output gradient ``do``. On CUDA tensors: delta by a
    torch expression, then the two backward kernels; CPU tensors take
    :func:`dense_attention_bwd`."""
    if q.device.type == "cpu":
        return dense_attention_bwd(q, k, v, o, lse, do, causal)
    do = do.contiguous()
    # delta = rowsum(dO * O) in fp32 from the saved o in its own dtype
    delta = (do.float() * o.float()).sum(dim=-1)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Attention over [BH, T, D] with the flash backward: the forward
    saves (q, k, v, o, lse) and the backward recomputes P from lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_with_lse(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal=False):
    """Multi-head attention over q [B, Tq, H, D] and k, v [B, Tk, H, D]
    -> [B, Tq, H, D] in q.dtype, differentiable through the flash
    backward. ``causal`` masks key j from query i unless i >= j."""
    b, tq, h, d = q.shape

    def to_bh(x):
        return x.transpose(1, 2).reshape(b * h, x.shape[1], d).contiguous()

    out = _FlashAttention.apply(to_bh(q), to_bh(k), to_bh(v), bool(causal))
    return out.reshape(b, h, tq, d).transpose(1, 2)


# --------------------------------------------------------- ring step ---

def carry_block_reference(q, k, v, o, m, l, q_offset, kv_offset, causal):
    """The updated carry (o, m, l) by plain tensor ops — the contract of
    :func:`flash_carry_block`, in the accumulation dtype (fp32, or
    float64 for float64 inputs): scores from q pre-scaled by 1/sqrt(D),
    masked at global positions to the finite -1e30; a call wholly past
    the diagonal returns the carry."""
    acc = _acc_dtype(q)
    tq, tk = q.shape[1], k.shape[1]
    if causal and kv_offset > q_offset + tq - 1:
        return tuple(t.to(acc, copy=True) for t in (o, m, l))
    qs = q.to(acc) * _scale(q)
    s = qs @ k.to(acc).transpose(1, 2)
    if causal:
        rows = torch.arange(tq, device=q.device)
        cols = torch.arange(tk, device=q.device)
        s = torch.where(q_offset + rows[:, None] >= kv_offset + cols[None, :],
                        s, NEG_INF)
    m_new = torch.maximum(m.to(acc), s.amax(dim=-1))
    alpha = torch.exp(m.to(acc) - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = alpha * l.to(acc) + p.sum(dim=-1)
    o_new = alpha[..., None] * o.to(acc) + p @ v.to(acc)
    return o_new, m_new, l_new


def flash_carry_block(q, k, v, o, m, l, q_offset, kv_offset, causal):
    """One ring-attention step: fold k, v [BH, Tk, D] into the
    UNNORMALISED carry of q [BH, Tq, D] — o [BH, Tq, D] and the running
    max m and sum l [BH, Tq], all fp32 — and return the new (o, m, l).
    ``q_offset`` and ``kv_offset`` (host ints) are the global positions of
    q's and k's first rows; with ``causal`` query i attends key j iff
    q_offset + i >= kv_offset + j. The caller normalises o / l at the end
    of the ring. Any Tq and Tk are taken.

    Launches ``flash_carry`` on CUDA tensors (float32 or bfloat16 q/k/v,
    D 64 or 128); CPU tensors take :func:`carry_block_reference`. A call
    whose K/V lie wholly past the diagonal returns the carry bitwise.

    Rows that have seen no unmasked key are unspecified: masked scores are
    the finite -1e30, so such a row gets p = 1 for every masked key of a
    key tile the kernel visits (l counts them, m stays -1e30), and which
    tiles are visited depends on the tile size (64 here, 128 in the JAX
    kernel, every key in its jnp route). A ring never makes such a row: its
    first step is the shard's own block, where every row sees its own key.

    Forward-only, as in JAX: raises if grad mode is on and any input
    requires a gradient."""
    _check_qkv(q, k, v)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, o, m, l)):
        raise RuntimeError("flash_carry_block is forward-only (as the JAX "
                           "carry kernel): no input may require a gradient")
    if o.shape != q.shape or m.shape != q.shape[:2] or l.shape != m.shape:
        raise ValueError("the carry must be o %s and m, l %s, not %s / %s / %s"
                         % (tuple(q.shape), tuple(q.shape[:2]),
                            tuple(o.shape), tuple(m.shape), tuple(l.shape)))
    q_offset, kv_offset = int(q_offset), int(kv_offset)
    if not all(-2 ** 31 <= x < 2 ** 31 for x in (q_offset, kv_offset)):
        raise ValueError("offsets must fit in int32")
    if q.device.type == "cpu":
        return carry_block_reference(q, k, v, o, m, l, q_offset, kv_offset,
                                     causal)
    for t in (o, m, l):
        if t.dtype != torch.float32:
            raise TypeError("the carry is float32, not %s" % t.dtype)
    _check_flash_inputs((q, k, v), (m, l))
    _check_flash_inputs((o,), (m, l))
    bh, tq, d = q.shape
    o_out, m_out, l_out = (torch.empty_like(t) for t in (o, m, l))
    status = _build.load("flash_attention").flash_carry(
        DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), m.data_ptr(), l.data_ptr(), o_out.data_ptr(),
        m_out.data_ptr(), l_out.data_ptr(), bh, tq, k.shape[1], d, q_offset,
        kv_offset, int(causal), _scale(q), _build.current_stream_ptr(q.device))
    _build.check(status, "flash_carry")
    _build.launches["flash_carry"] += 1
    return o_out, m_out, l_out


# ------------------------------------------------------------- decode ---


def dense_decode_with_lse(q, k_cache, v_cache, lengths):
    """(o [B, H, D] fp32, lse [B, H] fp32) by plain tensor ops — the
    contract of :func:`flash_decode_with_lse`. Rows with no valid key
    give o=0 and lse ~ -1e30."""
    b, h, d = q.shape
    t, kvh = k_cache.shape[1], k_cache.shape[2]
    if h % kvh:
        raise ValueError("query heads %d must be a multiple of KV heads %d"
                         % (h, kvh))
    g = h // kvh
    lengths = lane_ints(lengths, b, q.device)
    qg = q.reshape(b, kvh, g, d).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, k_cache.float()) / (d ** 0.5)
    valid = torch.arange(t, device=q.device)[None, :] < lengths[:, None]
    vmask = valid[:, None, None, :]
    s = torch.where(vmask, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(vmask, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", p, v_cache.float())
    o = o / torch.clamp(l, min=1e-30)[..., None]
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    return o.reshape(b, h, d), lse.reshape(b, h)


def flash_decode_with_lse(q, k_cache, v_cache, lengths):
    """Single-step (T_q=1) attention against a KV cache, with the
    log-sum-exp of each row's scores.

    q: [B, H, D]; k_cache / v_cache: [B, Tmax, KVH, D] with H a multiple
    of KVH (query heads [j*G, (j+1)*G) share cache head j); lengths: int32
    [B] or a scalar — row b attends its first lengths[b] positions.
    Returns (o [B, H, D] in q.dtype, lse [B, H] fp32); a row with no valid
    key gives o=0 and lse ~ -1e30, so it drops out of a cross-shard
    combine."""
    b, h, d = q.shape
    t_max, kvh = k_cache.shape[1], k_cache.shape[2]
    if h % kvh:
        raise ValueError("query heads %d must be a multiple of KV heads %d"
                         % (h, kvh))
    if k_cache.shape != (b, t_max, kvh, d) or v_cache.shape != k_cache.shape:
        raise ValueError("shape mismatch: q %s, caches %s / %s"
                         % (tuple(q.shape), tuple(k_cache.shape),
                            tuple(v_cache.shape)))
    lengths = lane_ints(lengths, b, q.device)
    if q.device.type == "cpu":
        o, lse = dense_decode_with_lse(q, k_cache, v_cache, lengths)
        return o.to(q.dtype), lse
    check_cuda_inputs((q, k_cache, v_cache, lengths), (lengths,), d,
                      h // kvh)
    # one ctypes call: the split pass on a (splits, KVH, B) grid and the
    # combine; the scratch holds each row's per-split (m, l, acc)
    splits, chunk = flash_decode_splits(b, kvh, t_max)
    out = torch.empty_like(q)
    lse = torch.empty((b, h), dtype=torch.float32, device=q.device)
    scratch = torch.empty(b * h * splits * (d + 2), dtype=torch.float32,
                          device=q.device)
    status = _build.load("decode_attention").flash_decode(
        DTYPE_CODE[q.dtype], q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        lse.data_ptr(), scratch.data_ptr(), b, kvh, t_max, d, h // kvh,
        splits, chunk, _build.current_stream_ptr(q.device))
    _build.check(status, "flash_decode")
    _build.launches["flash_decode"] += 1
    return out, lse


def flash_decode_splits(b, kvh, t_max):
    """(splits, chunk) of the flash-decode grid for B lanes x KVH heads of
    a Tmax-position cache: host ints only (``common.decode_splits``)."""
    return decode_splits(b, kvh, t_max, FLASH_DECODE_MULTIPLE)


def flash_decode(q, k_cache, v_cache, lengths):
    """:func:`flash_decode_with_lse` without the lse."""
    return flash_decode_with_lse(q, k_cache, v_cache, lengths)[0]

