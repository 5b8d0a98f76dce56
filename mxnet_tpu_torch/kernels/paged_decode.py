"""Batched-lane paged decode/verify attention (port of
``mxnet_tpu/kernels/paged_decode.py``).

``paged_attention`` reads one layer's block pool through per-lane block
tables for a whole batch of lanes. On CUDA tensors it launches the
``paged_decode`` kernel of ``csrc/decode_attention.cu``, which replaces
the TPU kernel ``_paged_kernel``: one CTA per (lane, KV head) walks only
the lane's live positions, reads each table entry itself, and packs the
G query heads of a KV head (times the span) as rows ``r = c*G + g`` so
each cache row is read once per group. Its bound is the live K/V bytes
(about G flops per byte of bf16 cache); it reads K twice and V once
because the reference rounds the normalised probabilities to the cache
dtype before PV, which needs the row statistics before any probability
exists.

``paged_attention_reference`` is the plain version, and what the CPU
runs: gather the pool through the tables into the dense [B, T] layout,
masked grouped softmax, normalised probabilities cast to the cache
dtype, PV accumulated in fp32 — the op order of the JAX package's
``decode_step_paged`` / ``verify_chunk_paged`` gather path.
"""

import math

import torch

from . import _build
from .common import DTYPE_CODE, NEG_INF, check_cuda_inputs

__all__ = ["paged_attention", "paged_attention_reference"]


def paged_attention_reference(q, layer_pool, tables, pos):
    """Plain PyTorch version of :func:`paged_attention` (same contract)."""
    b, span, h, d = q.shape
    kpool, vpool = layer_pool["k"], layer_pool["v"]
    _, bs, kvh, _ = kpool.shape
    g = h // kvh
    t = tables.shape[1] * bs
    idx = tables.long()
    ck = kpool[idx].reshape(b, t, kvh, d)
    cv = vpool[idx].reshape(b, t, kvh, d)
    positions = pos.long()[:, None] + torch.arange(span, device=q.device)
    mask = torch.arange(t, device=q.device)[None, None, :] \
        <= positions[:, :, None]                              # [B, C, T]
    qg = q.reshape(b, span, kvh, g, d)
    s = torch.einsum("bckgd,btkd->bckgt", qg.float(), ck.float()) \
        / math.sqrt(d)
    s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bckgt,btkd->bckgd", a.to(cv.dtype).float(),
                     cv.float())
    return o.to(q.dtype).reshape(b, span, h, d)


def paged_attention(q, layer_pool, tables, pos):
    """Attention of a batch of lanes straight against one layer's pool.

    q: [B, C, H, D] — C=1 is plain decode, C=k+1 the speculative verify
    window (row (b, c) holds the query at stream position pos[b]+c).
    layer_pool: {"k", "v": [NB, bs, KVH, D]}, float32 or bfloat16 like q.
    tables: [B, NB_lane] int32; entry j covers positions [j*bs, (j+1)*bs),
    unallocated entries point at the null block 0.
    pos: [B] int32 (or a scalar, broadcast) — row (b, c) attends pool
    positions <= pos[b] + c, whose K/V must already be in the pool.

    Returns [B, C, H, D] in q.dtype.
    """
    if "ks" in layer_pool:
        raise NotImplementedError(
            "int8 KV pools (the paged kernel's int8 mode) arrive with the "
            "int8-KV slice")
    kpool, vpool = layer_pool["k"], layer_pool["v"]
    if q.dim() != 4 or kpool.dim() != 4 or tables.dim() != 2:
        raise ValueError("q must be [B, C, H, D], pools [NB, bs, KVH, D] "
                         "and tables [B, NB_lane]")
    b, span, h, d = q.shape
    _, bs, kvh, dk = kpool.shape
    if h % kvh:
        raise ValueError("query heads %d must be a multiple of KV heads %d"
                         % (h, kvh))
    if dk != d or vpool.shape != kpool.shape or tables.shape[0] != b:
        raise ValueError("shape mismatch: q %s, pools %s / %s, tables %s"
                         % (tuple(q.shape), tuple(kpool.shape),
                            tuple(vpool.shape), tuple(tables.shape)))
    pos = torch.as_tensor(pos, dtype=torch.int32,
                          device=q.device).expand(b).contiguous()
    if q.device.type == "cpu":
        return paged_attention_reference(q, layer_pool, tables, pos)
    g = h // kvh
    check_cuda_inputs((q, kpool, vpool, tables, pos), (tables, pos), d,
                      span * g)
    out = torch.empty_like(q)
    lib = _build.load("decode_attention")
    status = lib.paged_decode(
        DTYPE_CODE[q.dtype], q.data_ptr(), kpool.data_ptr(),
        vpool.data_ptr(), tables.data_ptr(), pos.data_ptr(),
        out.data_ptr(), b, kvh, d, bs, tables.shape[1], span, g,
        _build.current_stream_ptr(q.device))
    _build.check(status, "paged_decode")
    _build.launches["paged_decode"] += 1
    return out

