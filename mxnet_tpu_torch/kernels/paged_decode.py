"""Batched-lane paged decode/verify attention (port of
``mxnet_tpu/kernels/paged_decode.py``).

``paged_attention`` reads one layer's block pool through per-lane block
tables for a whole batch of lanes. On CUDA tensors it launches kernels
of ``csrc/decode_attention.cu`` that replace the TPU kernel
``_paged_kernel``: ``paged_decode`` for float32/bfloat16 pools, and
``paged_decode_int8`` for int8 pools with fp32 scale planes (the TPU
kernel's ``int8=True`` mode). Each CTA reads its table entries itself
and packs the G query heads of a KV head (times the span) as rows
``r = c*G + g``, so each cache row is read once per group. The bound is
the live K/V bytes (about G flops per byte of bf16 cache), and the
reference quantises the normalised probabilities (rounds them to the
cache dtype, or re-quantises them to int8 codes with the row's own
scale) before PV, which needs each row's statistics before any
probability exists.

Both modes are split-K over the sequence, so that a serving batch fills
the card's 132 SMs: a (splits, KVH, B) grid whose CTA s walks positions
[s * chunk, (s + 1) * chunk) of its lane (chunk a multiple of the block
size, from ``common.decode_splits``: shapes only, never ``pos``), in two
passes and a combine, all from one ctypes call. Pass 1 writes each
split's row statistics (m, l; for int8 also amax, the largest
exp(s - m) * vs) and every score to one fp32 scratch buffer; pass 2
merges all splits' statistics in a fixed order, rounds exp(s - m) / l to
the cache dtype (int8: re-quantises it with the row's scale) from the
stored scores and writes its chunk's PV (int8: exact int32 sums); the
combine sums the splits in order. K and V are each read once. The int8
passes copy each chunk's table entries to shared memory once and stream
its code rows and scales through a ring of ``cp.async`` copies, with
both integer dots on ``dp4a``. On the CPU, ``tests/test_torch_kv_int8.py``
holds the plain version against the JAX kernel and
``tests/test_torch_int8_split.py`` models the int8 passes split by
split; on the card ``chip_smoke.py`` holds the kernel against the plain
version on the served pool, at 16 query rows a KV head and on the split
plan's edges, two calls bitwise equal.

``paged_attention_reference`` is the plain version, and what the CPU
runs: gather the pool through the tables into the dense [B, T] layout,
then the dense contraction of the JAX package's ``decode_step_paged`` /
``verify_chunk_paged`` gather path — the masked grouped softmax with the
probabilities cast to the cache dtype and PV accumulated in fp32, or,
for an int8 pool, ``common.int8_cache_attention``.
"""

import math

import torch

from . import _build
from .common import (DTYPE_CODE, MAX_ROWS, NEG_INF, check_cuda_inputs,
                     decode_splits, int8_cache_attention, lane_ints)

__all__ = ["paged_attention", "paged_attention_reference",
           "paged_decode_splits", "span_slices"]


def _gather(layer_pool, tables):
    """Every leaf of one layer's pool gathered through the tables into the
    dense [B, NB_lane * bs, ...] layout, in position order."""
    b, nbl = tables.shape
    idx = tables.long()
    return {name: leaf[idx].reshape((b, nbl * leaf.shape[1])
                                    + tuple(leaf.shape[2:]))
            for name, leaf in layer_pool.items()}


def paged_attention_reference(q, layer_pool, tables, pos):
    """Plain PyTorch version of :func:`paged_attention` (same contract)."""
    b, span, h, d = q.shape
    kvh = layer_pool["k"].shape[2]
    g = h // kvh
    att = _gather(layer_pool, tables)
    t = att["k"].shape[1]
    positions = pos.long()[:, None] + torch.arange(span, device=q.device)
    mask = torch.arange(t, device=q.device)[None, None, :] \
        <= positions[:, :, None]                              # [B, C, T]
    qg = q.reshape(b, span, kvh, g, d)
    if "ks" in layer_pool:
        return int8_cache_attention(qg, att, mask, q.dtype).reshape(
            b, span, h, d)
    ck, cv = att["k"], att["v"]
    s = torch.einsum("bckgd,btkd->bckgt", qg.float(), ck.float()) \
        / math.sqrt(d)
    s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bckgt,btkd->bckgd", a.to(cv.dtype).float(),
                     cv.float())
    return o.to(q.dtype).reshape(b, span, h, d)


def _check_int8_pool(layer_pool):
    kpool, vpool = layer_pool["k"], layer_pool["v"]
    ks, vs = layer_pool["ks"], layer_pool["vs"]
    if kpool.dtype != torch.int8 or vpool.dtype != torch.int8:
        raise TypeError("an int8 pool holds int8 codes, not %s / %s"
                        % (kpool.dtype, vpool.dtype))
    if ks.dtype != torch.float32 or vs.dtype != torch.float32:
        raise TypeError("an int8 pool's scale planes are float32")
    planes = kpool.shape[:3]
    if ks.shape != planes or vs.shape != planes:
        raise ValueError("scale planes %s / %s do not match the pool %s"
                         % (tuple(ks.shape), tuple(vs.shape),
                            tuple(kpool.shape)))


def paged_attention(q, layer_pool, tables, pos):
    """Attention of a batch of lanes straight against one layer's pool.

    q: [B, C, H, D] — C=1 is plain decode, C=k+1 the speculative verify
    window (row (b, c) holds the query at stream position pos[b]+c).
    layer_pool: {"k", "v": [NB, bs, KVH, D]}, float32 or bfloat16 like q;
    or, for an int8 KV pool (detected by key, as every pool consumer
    does), int8 codes plus {"ks", "vs": [NB, bs, KVH]} float32 scales.
    tables: [B, NB_lane] int32; entry j covers positions [j*bs, (j+1)*bs),
    unallocated entries point at the null block 0.
    pos: [B] int32 (or a scalar, broadcast) — row (b, c) attends pool
    positions <= pos[b] + c, whose K/V must already be in the pool.

    Any span is taken: a window of more than MAX_ROWS // G positions
    launches the kernel once per slice (:func:`span_slices`).

    Returns [B, C, H, D] in q.dtype.
    """
    int8 = "ks" in layer_pool
    kpool, vpool = layer_pool["k"], layer_pool["v"]
    if q.dim() != 4 or kpool.dim() != 4 or tables.dim() != 2:
        raise ValueError("q must be [B, C, H, D], pools [NB, bs, KVH, D] "
                         "and tables [B, NB_lane]")
    b, _, h, d = q.shape
    kvh, dk = kpool.shape[2:]
    if h % kvh:
        raise ValueError("query heads %d must be a multiple of KV heads %d"
                         % (h, kvh))
    if dk != d or vpool.shape != kpool.shape or tables.shape[0] != b:
        raise ValueError("shape mismatch: q %s, pools %s / %s, tables %s"
                         % (tuple(q.shape), tuple(kpool.shape),
                            tuple(vpool.shape), tuple(tables.shape)))
    if int8:
        _check_int8_pool(layer_pool)
    pos = lane_ints(pos, b, q.device)
    if q.device.type == "cpu":
        return paged_attention_reference(q, layer_pool, tables, pos)
    return span_slices(_launch, q, layer_pool, tables, pos)


def span_slices(launch, q, layer_pool, tables, pos):
    """``launch(q, layer_pool, tables, pos)`` over the span of q [B, C, H,
    D] in slices the kernels take: a CTA holds at most MAX_ROWS query rows
    of a (lane, KV head), span x G, so a window with C * G > MAX_ROWS (a
    verify window of spec_k + 1 at a large group) runs as slices of
    MAX_ROWS // G positions, each launched with pos shifted by the slice's
    offset. Rows are independent, so the slices give the one-piece result
    exactly. One launch when the window fits."""
    span = q.shape[1]
    g = q.shape[2] // layer_pool["k"].shape[2]
    step = max(MAX_ROWS // g, 1)
    if span <= step:
        return launch(q, layer_pool, tables, pos)
    return torch.cat([launch(q[:, c:c + step].contiguous(), layer_pool,
                             tables, pos + c)
                      for c in range(0, span, step)], dim=1)


def _launch(q, layer_pool, tables, pos):
    """One launch of the paged kernel (its int8 mode for an int8 pool) on
    CUDA tensors whose span x G fits a CTA."""
    int8 = "ks" in layer_pool
    kpool, vpool = layer_pool["k"], layer_pool["v"]
    b, span, h, d = q.shape
    _, bs, kvh, _ = kpool.shape
    g = h // kvh
    out = torch.empty_like(q)
    if int8:
        check_cuda_inputs((q, tables, pos), (tables, pos), d, span * g)
        _check_int8_leaves(layer_pool, q.device, d)
    else:
        check_cuda_inputs((q, kpool, vpool, tables, pos), (tables, pos), d,
                          span * g)
    # one ctypes call: both passes on a (splits, KVH, B) grid and the
    # combine; the scratch holds, per query row, each split's statistics
    # ((m, l), or (m, l, amax) for int8) and PV partial (fp32, or int32
    # for int8) and a score for every table position
    nbl = tables.shape[1]
    splits, chunk = paged_decode_splits(b, kvh, nbl, bs)
    stats = 3 if int8 else 2
    scratch = torch.empty(b * h * span * (splits * (d + stats) + nbl * bs),
                          dtype=torch.float32, device=q.device)
    lib = _build.load("decode_attention")
    if int8:
        status = lib.paged_decode_int8(
            DTYPE_CODE[q.dtype], q.data_ptr(), kpool.data_ptr(),
            vpool.data_ptr(), layer_pool["ks"].data_ptr(),
            layer_pool["vs"].data_ptr(), tables.data_ptr(), pos.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), b, kvh, d, bs, nbl, span, g,
            splits, chunk, _build.current_stream_ptr(q.device))
        _build.check(status, "paged_decode_int8")
        _build.launches["paged_decode_int8"] += 1
        return out
    status = lib.paged_decode(
        DTYPE_CODE[q.dtype], q.data_ptr(), kpool.data_ptr(),
        vpool.data_ptr(), tables.data_ptr(), pos.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), b, kvh, d, bs, nbl, span, g,
        splits, chunk, _build.current_stream_ptr(q.device))
    _build.check(status, "paged_decode")
    _build.launches["paged_decode"] += 1
    return out


def paged_decode_splits(b, kvh, nbl, bs):
    """(splits, chunk) of the paged-decode grid for B lanes x KVH heads of
    ``nbl``-entry tables of ``bs``-position blocks: host ints only, the
    chunk a multiple of ``bs`` (``common.decode_splits``)."""
    return decode_splits(b, kvh, nbl * bs, bs)


def _check_int8_leaves(layer_pool, device, d):
    """The int8 kernels' own rules for a pool's leaves: contiguous, on
    ``device`` and 16-byte aligned (a code row is copied in 16-byte
    pieces), with a head dim of 32, 64 or 128 codes. A decode step runs
    this once per layer: device indices as ints, no torch.device
    objects."""
    if d not in (32, 64, 128):
        raise ValueError("head dim %d is not supported by the int8 paged "
                         "kernel (32, 64 or 128)" % d)
    index = device.index
    for name, t in layer_pool.items():
        if t.get_device() != index or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("the int8 paged kernel takes contiguous, "
                             "16-byte aligned pool leaves on %s (%s)"
                             % (device, name))
