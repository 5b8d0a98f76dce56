"""Ring attention — sequence parallelism over a mesh axis (port of
``mxnet_tpu/parallel/ring.py``).

Sequences are sharded over the 'sp' mesh axis and attention runs
blockwise: each rank folds its own K/V shard into an online-softmax
carry (o, m, l), then passes its K/V to the next rank around the ring
(``ring_permute``, a ``batch_isend_irecv``) and folds the shard it
receives, n - 1 times, so no rank holds the whole sequence. The carry
is normalised once at the end, so the result is full attention to fp
tolerance.

Each rank runs :func:`ring_attention` on its own shard, as the body of
the JAX package's ``shard_map`` does; :func:`ring_attention_sharded`
takes global arrays, as the JAX function does, slices this rank's shard
and all-gathers the output, so every rank returns what the JAX global
array holds. With ``use_flash_kernel`` each fold is the hand-written
carry kernel (``kernels.flash_attention.flash_carry_block``) on CUDA
tensors; without it, the fold is ``local_attention_block``'s plain
tensor route, which, as in JAX, scales the scores after the dot.

:func:`sp_flash_decode` is the serving complement: single-token
attention against a KV cache sharded over sp, one (o, lse) per shard
combined by their log-sum-exp weights. Each shard runs the flash-decode
kernel on CUDA tensors by default (``use_pallas=False`` picks the plain
dense route); the JAX package's ``MXNET_SP_DECODE_PALLAS`` switch, set
by a TPU measurement, is not carried.

Left out of the JAX module: ``_watched_dispatch`` and its chaos and
watchdog hooks (observability, ported last), the ``_shard_map`` API
shims and the vma / ``pcast`` plumbing (a rank runs its shard directly,
so nothing is mapped), and the interpret-mode fallbacks (no interpret
mode here: CPU tensors take the kernels' plain versions).
"""

import math

import torch

from ..kernels.common import NEG_INF
from ..kernels.flash_attention import (dense_decode_with_lse,
                                       flash_carry_block,
                                       flash_decode_with_lse)
from . import all_gather, all_reduce, current_mesh, ring_permute

__all__ = ["ring_attention", "local_attention_block",
           "ring_attention_sharded", "sp_flash_decode"]


def local_attention_block(q, k, v, q_offset, kv_offset, causal, scale,
                          carry=None, use_flash_kernel=False):
    """One flash-attention block update.

    q: [B, Tq, H, D]; k, v: [B, Tk, H, D]. Offsets are the global
    positions of element 0 of the q / kv blocks (for causal masking).
    carry = (o [B, Tq, H, D], m [B, H, Tq], l [B, H, Tq]), all fp32, the
    running output, max and denominator, or None to start.

    ``use_flash_kernel`` routes the block through the carry kernel
    (:func:`_flash_block`); otherwise the scores are formed by plain
    tensor ops in fp32 and scaled after the dot, as the JAX jnp route."""
    if use_flash_kernel:
        return _flash_block(q, k, v, q_offset, kv_offset, causal, carry)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_pos = q_offset + torch.arange(tq, device=q.device)
        kv_pos = kv_offset + torch.arange(tk, device=q.device)
        mask = q_pos[:, None] >= kv_pos[None, :]
        scores = torch.where(mask[None, None], scores, NEG_INF)
    if carry is None:
        o = torch.zeros((b, tq, h, d), dtype=torch.float32, device=q.device)
        m = torch.full((b, h, tq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, tq), dtype=torch.float32, device=q.device)
    else:
        o, m, l = carry
    m_new = torch.maximum(m, scores.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    l_new = alpha * l + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o_new = alpha.transpose(1, 2)[..., None] * o + pv
    return o_new, m_new, l_new


def _flash_block(q, k, v, q_offset, kv_offset, causal, carry):
    """local_attention_block through the carry kernel, on the same
    (o [B, Tq, H, D], m / l [B, H, Tq]) carry layout; the kernel works on
    [B*H, T, D]."""
    b, tq, h, d = q.shape

    def to_bh(x):
        return x.transpose(1, 2).reshape(b * h, x.shape[1], d).contiguous()

    if carry is None:
        o = torch.zeros((b * h, tq, d), dtype=torch.float32, device=q.device)
        m = torch.full((b * h, tq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b * h, tq), dtype=torch.float32, device=q.device)
    else:
        o_c, m_c, l_c = carry
        o = to_bh(o_c)
        m = m_c.reshape(b * h, tq)
        l = l_c.reshape(b * h, tq)
    o, m, l = flash_carry_block(to_bh(q), to_bh(k), to_bh(v), o, m, l,
                                q_offset, kv_offset, causal)
    return (o.reshape(b, h, tq, d).transpose(1, 2), m.reshape(b, h, tq),
            l.reshape(b, h, tq))


def ring_attention(q, k, v, axis_name="sp", causal=True,
                   use_flash_kernel=False, mesh=None):
    """Blockwise ring attention on this rank's sequence shard. Every rank
    of the ``axis_name`` group calls it together.

    q, k, v: [B, T_local, H, D], this rank's shard (its global offset is
    its coordinate on the axis times T_local). Returns [B, T_local, H, D]
    in q.dtype. The own block is folded first, then n - 1 rounds each
    rotate K/V one rank along the ring and fold the block received,
    whose global index is one lower (mod n)."""
    mesh = mesh or current_mesh()
    n = mesh.axis_size(axis_name)
    idx = mesh.axis_index(axis_name)
    t = q.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    q_offset = idx * t
    carry = local_attention_block(q, k, v, q_offset, idx * t, causal, scale,
                                  use_flash_kernel=use_flash_kernel)
    kv_idx = idx
    for _ in range(n - 1):
        k = ring_permute(k, axis_name, mesh=mesh)
        v = ring_permute(v, axis_name, mesh=mesh)
        kv_idx = (kv_idx - 1) % n
        carry = local_attention_block(q, k, v, q_offset, kv_idx * t, causal,
                                      scale, carry=carry,
                                      use_flash_kernel=use_flash_kernel)
    o, _, l = carry
    out = o / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def _local_slice(x, mesh, axis_name, dim):
    """This rank's block of ``x`` along ``dim`` over the axis (all of it
    when ``axis_name`` is None)."""
    if axis_name is None:
        return x
    n = mesh.axis_size(axis_name)
    size = x.shape[dim]
    if size % n:
        raise ValueError("dimension %d of size %d does not split over the "
                         "%d ranks of axis %r" % (dim, size, n, axis_name))
    block = size // n
    return x.narrow(dim, mesh.axis_index(axis_name) * block, block)


def ring_attention_sharded(q, k, v, mesh, axis_name="sp", causal=True,
                           batch_axis=None, use_flash_kernel=False):
    """Ring attention over GLOBAL arrays [B, T, H, D]: each rank takes its
    T shard over ``axis_name`` (and its B shard over ``batch_axis``), runs
    :func:`ring_attention`, and all-gathers the output, so every rank
    returns the global [B, T, H, D]."""
    q, k, v = (_local_slice(_local_slice(x, mesh, axis_name, 1), mesh,
                            batch_axis, 0) for x in (q, k, v))
    out = ring_attention(q, k, v, axis_name=axis_name, causal=causal,
                         use_flash_kernel=use_flash_kernel, mesh=mesh)
    out = all_gather(out, axis_name, axis=1, mesh=mesh)
    if batch_axis is not None:
        out = all_gather(out, batch_axis, axis=0, mesh=mesh)
    return out


def sp_flash_decode(q, k_cache, v_cache, lengths, mesh, axis_name="sp",
                    batch_axis=None, use_pallas=True):
    """Sequence-parallel DECODING: single-token attention against a KV
    cache sharded over ``axis_name`` along its sequence dim.

    q: [B, H, D] (the same on every rank of the axis); k_cache / v_cache:
    global [B, Tmax, KVH, D], of which this rank reads its Tmax shard;
    lengths: [B] (or a scalar) GLOBAL valid lengths. Each rank computes
    (o, lse) over its shard with the length clipped to it, then the
    partial results combine with their log-sum-exp weights: a max and two
    sums over the axis instead of gathering the cache. Shards with no
    valid key come back o=0, lse ~ -1e30 and drop out of the combine.
    Returns [B, H, D] in q.dtype on every rank.

    The per-shard compute is ``flash_decode_with_lse`` (the flash-decode
    kernel on CUDA tensors); ``use_pallas=False`` (the JAX argument's
    name) takes ``dense_decode_with_lse`` instead."""
    b = q.shape[0]
    lengths = torch.as_tensor(lengths, dtype=torch.int32,
                              device=q.device).expand(b)
    q_l = _local_slice(q, mesh, batch_axis, 0).contiguous()
    k_l, v_l = (_local_slice(_local_slice(c, mesh, axis_name, 1), mesh,
                             batch_axis, 0).contiguous()
                for c in (k_cache, v_cache))
    len_l = _local_slice(lengths, mesh, batch_axis, 0)
    t_shard = k_l.shape[1]
    local_len = torch.clamp(len_l - mesh.axis_index(axis_name) * t_shard,
                            0, t_shard).to(torch.int32)
    if use_pallas:
        o_i, lse_i = flash_decode_with_lse(q_l, k_l, v_l, local_len)
        o_i = o_i.float()
    else:
        o_i, lse_i = dense_decode_with_lse(q_l, k_l, v_l, local_len)
    # combine the partial softmaxes across the sp shards
    m_g = all_reduce(lse_i, axis_name, op="max", mesh=mesh)
    w = torch.exp(lse_i - m_g)
    num = all_reduce(w[..., None] * o_i, axis_name, mesh=mesh)
    den = all_reduce(w, axis_name, mesh=mesh)
    out = (num / torch.clamp(den, min=1e-30)[..., None]).to(q.dtype)
    if batch_axis is not None:
        out = all_gather(out, batch_axis, axis=0, mesh=mesh)
    return out
