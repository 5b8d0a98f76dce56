"""Decode attention against a dense KV cache (port of the decode part of
``mxnet_tpu/kernels/flash_attention.py``).

``flash_decode`` / ``flash_decode_with_lse`` launch the ``flash_decode``
kernel of ``csrc/decode_attention.cu`` on CUDA tensors. It replaces the
TPU kernel ``_decode_kernel``: one CTA per (lane, KV head) streams the
lane's first ``lengths[b]`` cache rows once, for all G query heads of
the group, with q pre-scaled by 1/sqrt(D) in fp32 and a single-pass
online softmax. Its bound is the live K/V bytes (about G flops per byte
of bf16 cache); the cache is read once and nothing but (o, lse) is
written.

``dense_decode_with_lse`` is the plain version, and what the CPU runs:
the same contract by plain tensor ops, PV accumulated in fp32.

The training kernels of the JAX module (flash forward and backward, and
the ring step) are not ported yet.
"""

import torch

from . import _build
from .common import DTYPE_CODE, NEG_INF, check_cuda_inputs

__all__ = ["flash_decode", "flash_decode_with_lse", "dense_decode_with_lse"]


def _lengths(lengths, b, device):
    return torch.as_tensor(lengths, dtype=torch.int32,
                           device=device).expand(b).contiguous()


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
    lengths = _lengths(lengths, b, q.device)
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
    lengths = _lengths(lengths, b, q.device)
    if q.device.type == "cpu":
        o, lse = dense_decode_with_lse(q, k_cache, v_cache, lengths)
        return o.to(q.dtype), lse
    g = h // kvh
    check_cuda_inputs((q, k_cache, v_cache, lengths), (lengths,), d, g)
    out = torch.empty_like(q)
    lse = torch.empty((b, h), dtype=torch.float32, device=q.device)
    lib = _build.load("decode_attention")
    status = lib.flash_decode(
        DTYPE_CODE[q.dtype], q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, kvh, t_max, d, g,
        _build.current_stream_ptr(q.device))
    _build.check(status, "flash_decode")
    _build.launches["flash_decode"] += 1
    return out, lse


def flash_decode(q, k_cache, v_cache, lengths):
    """:func:`flash_decode_with_lse` without the lse."""
    return flash_decode_with_lse(q, k_cache, v_cache, lengths)[0]

