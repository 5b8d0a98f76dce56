"""Shared plumbing of the decode kernels: the mask value and the block
rules, kept from the JAX package's ``kernels/common.py`` so the port
needs nothing of it, and the int8 KV quantiser with the one int8 cache
contraction (``models/transformer.py``'s ``_kv_quant``, ``_kv_dequant``
and ``_int8_cache_attention`` in the JAX package), shared by the model
and the paged kernel's plain version. The TPU layout rule for row
statistics (128 equal lanes) has no counterpart here: the CUDA kernels
keep their statistics in registers and shared memory."""

import functools
import math
import warnings

import torch

NEG_INF = -1e30

# float dtypes the CUDA kernels take, as the code their C entry expects
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_ROWS = 16           # query rows per (lane, KV head) in one CTA
MAX_HEAD_DIM = 128

MIN_BLOCK = 8           # below this the grid is degenerate, not tiled

# split-K of the decode kernels (B3's fp32/bf16 mode and B4)
SM_COUNT = 132                  # streaming multiprocessors of an H100 SXM
DECODE_CTAS = 16 * SM_COUNT     # CTAs a decode launch aims for
DECODE_MIN_CHUNK = 256          # positions one split walks at the least
DECODE_MAX_SPLITS = 64          # the kernels' kMaxSplits


@functools.lru_cache(maxsize=None, typed=True)
def decode_splits(lanes, kvh, capacity, multiple=1):
    """(splits, chunk) of a split-K decode launch over ``lanes`` x ``kvh``
    (lane, KV head) pairs whose caches hold ``capacity`` positions: split
    s walks positions [s * chunk, (s + 1) * chunk), chunk is a multiple of
    ``multiple``, and the chunks cover [0, capacity) with none starting at
    or past it.

    Pure arithmetic on Python ints: it never sees the lanes' lengths, so
    a decode step that calls it reads nothing back from the device. It
    takes as many splits as bring the grid to DECODE_CTAS CTAs, but no
    chunk shorter than DECODE_MIN_CHUNK positions (a split's fixed cost,
    its query rows and its partial written and merged, stays small beside
    the cache rows it reads) and at most DECODE_MAX_SPLITS. ``chunk`` is
    the largest chunk: each CTA takes for its lane the live length over
    the splits, rounded up to a granule, at most ``chunk``, so a lane
    shorter than the capacity spreads over the splits too. The query rows
    per CTA (G, or span * G) do not enter: they change the arithmetic per
    key, not the bytes in flight. Cached by its arguments (``typed``, so
    4096.0 is not taken for 4096): a decode step pays one lookup."""
    for name, value in (("lanes", lanes), ("kvh", kvh),
                        ("capacity", capacity), ("multiple", multiple)):
        if not isinstance(value, int) or value < 1:
            raise TypeError("decode_splits takes positive Python ints "
                            "(%s=%r)" % (name, value))
    most = min(DECODE_MAX_SPLITS, max(1, capacity // DECODE_MIN_CHUNK))
    want = -(-DECODE_CTAS // (lanes * kvh))
    chunk = -(-capacity // max(1, min(most, want)))
    chunk = -(-chunk // multiple) * multiple
    return -(-capacity // chunk), chunk


def adjust_block(block, seq, name, family="flash_attention"):
    """Clamp ``block`` to ``seq`` and make it divide; when the gcd would
    collapse below ``MIN_BLOCK`` (a prime or odd ``seq``), fall back to
    one full-sequence block and warn."""
    adjusted = min(block, seq)
    if seq % adjusted:
        adjusted = math.gcd(seq, adjusted)
    if adjusted < min(seq, MIN_BLOCK):
        warnings.warn(
            "%s: %s=%d does not divide sequence length %d "
            "and the gcd adjustment collapses to %d (a degenerate "
            "%d-step grid); falling back to a single full-sequence "
            "block of %d. Pick a %s that divides the sequence to tile "
            "properly." % (family, name, block, seq, adjusted,
                           seq // max(adjusted, 1), seq, name),
            stacklevel=3)
        return seq
    return adjusted


def choose_block_k(t_max, candidates=(512, 256, 128), multiple=1):
    """The first of ``candidates`` that divides ``t_max`` and is a
    multiple of ``multiple``, else one full-length block."""
    choice = next((bb for bb in candidates
                   if bb % multiple == 0 and t_max % bb == 0), t_max)
    return min(choice, t_max)


def _f32(value, like):
    """``value`` as a 0-dim fp32 tensor on ``like``'s device. Dividing by
    it is a true division on CUDA too, where a Python number as divisor
    becomes a product with its rounded reciprocal."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def kv_quant(x):
    """Symmetric int8 over the last axis: x [..., D] -> (codes int8
    [..., D], scale fp32 [...]). In fp32: scale = max(max|x|, 1e-8) / 127,
    codes = clip(round(x / scale), -127, 127) with true divisions and
    round half to even, as the JAX package's ``_kv_quant``."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / _f32(127.0, x)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def kv_dequant(q8, scale, dtype):
    return (q8.float() * scale[..., None]).to(dtype)


def int8_cache_attention(qg, layer_cache, mask, out_dtype):
    """The one int8 cache contraction (decode is its C=1 case): qg
    [B, C, KVH, G, D] float against cache codes [B, T, KVH, D] int8 with
    scale planes ``ks``/``vs`` [B, T, KVH]; mask [B|1, C, T] marks the
    attendable positions. q is quantised per call; the scores are
    s * qs * ks / sqrt(D), masked, softmaxed; a * vs is re-quantised with
    each row's own scale and contracted with the V codes; the integer
    sum times that scale is cast to ``out_dtype``.

    Both integer dots must be exact, as the JAX package's int8 x int8 ->
    int32 products are. torch's einsum on int8 returns int8 and wraps,
    and CUDA has no int32 batched matmul; fp32 holds QK^T exactly
    (|s| <= 127^2 D < 2^24) but not PV (127^2 T reaches 2^24 at
    T = 1040). So both dots run in float64, exact below 2^53, i.e. for
    T < 2^53 / 127^2 ~ 5.6e11 positions."""
    kq, ks = layer_cache["k"], layer_cache["ks"]
    vq, vs = layer_cache["v"], layer_cache["vs"]
    dh = qg.shape[-1]
    q8, qs = kv_quant(qg)
    s = torch.einsum("bckgd,btkd->bckgt", q8.double(), kq.double()).float()
    s = s * qs[..., None] * ks.transpose(1, 2)[:, None, :, None, :] \
        / _f32(math.sqrt(dh), qg)
    s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
    a = torch.softmax(s, dim=-1)
    a8, as_ = kv_quant(a * vs.transpose(1, 2)[:, None, :, None, :])
    o = torch.einsum("bckgt,btkd->bckgd", a8.double(), vq.double()).float()
    return (o * as_[..., None]).to(out_dtype)


def lane_ints(x, b, device):
    """``x`` (an int, a scalar or a [B] tensor) as a contiguous int32 [B]
    tensor on ``device``: the decode kernels' positions and lengths. One
    already so is returned as it is, without a new view, since a decode
    step hands its [B] positions to every layer's wrapper."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.int32 \
            and x.shape == (b,) and x.device == device \
            and x.is_contiguous():
        return x
    return torch.as_tensor(x, dtype=torch.int32,
                           device=device).expand(b).contiguous()


def check_cuda_inputs(tensors, int_tensors, head_dim, rows):
    """Validate what a decode kernel is handed: contiguous tensors on one
    CUDA device, the floats (``tensors[0]``'s dtype, float32 or bfloat16)
    16-byte aligned, the ``int_tensors`` int32, and a head dim and row
    count the kernels were built for (a thread loads 16 bytes of a row,
    so ``head_dim`` is a multiple of 4 fp32 / 8 bf16 values, at most
    MAX_HEAD_DIM, with a power-of-two number of such vectors)."""
    device, dtype = tensors[0].device, tensors[0].dtype
    if dtype not in DTYPE_CODE:
        raise TypeError("the decode kernels take float32 or bfloat16, "
                        "not %s" % dtype)
    vec = 16 // tensors[0].element_size()
    n_vec = head_dim // vec
    if head_dim % vec or head_dim > MAX_HEAD_DIM or n_vec & (n_vec - 1):
        raise ValueError("head dim %d is not supported by the decode "
                         "kernels for %s" % (head_dim, dtype))
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError("%d query rows per KV head (span * group) exceed "
                         "the kernels' %d" % (rows, MAX_ROWS))
    # a decode step runs this once per layer: plain int and identity
    # tests only (get_device, id), no torch.device objects in the loop
    index, ints = tensors[0].get_device(), [id(t) for t in int_tensors]
    for t in tensors:
        if t.get_device() != index:
            raise ValueError("all tensors must be on %s (got %s)"
                             % (device, t.device))
        if not t.is_contiguous():
            raise ValueError("the decode kernels take contiguous tensors")
        if id(t) in ints:
            if t.dtype != torch.int32:
                raise TypeError("indices and lengths must be int32")
        elif t.dtype != dtype:
            raise TypeError("q and the cache must share one dtype "
                            "(%s vs %s)" % (dtype, t.dtype))
        elif t.data_ptr() % 16:
            raise ValueError("the decode kernels need 16-byte aligned "
                             "float tensors")
    if device.type != "cuda":
        raise ValueError("the decode kernels run on a CUDA device, not %s"
                         % device)
