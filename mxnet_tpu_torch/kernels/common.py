"""Shared plumbing of the decode kernels: the mask value and the block
rules, kept from the JAX package's ``kernels/common.py`` so the port
needs nothing of it. The TPU layout rule for row statistics (128 equal
lanes) has no counterpart here: the CUDA kernels keep their statistics in
registers and shared memory."""

import math
import warnings

import torch

NEG_INF = -1e30

# float dtypes the CUDA kernels take, as the code their C entry expects
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_ROWS = 16           # query rows per (lane, KV head) in one CTA
MAX_HEAD_DIM = 128

MIN_BLOCK = 8           # below this the grid is degenerate, not tiled


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
    for t in tensors:
        if t.device != device:
            raise ValueError("all tensors must be on %s (got %s)"
                             % (device, t.device))
        if not t.is_contiguous():
            raise ValueError("the decode kernels take contiguous tensors")
        if any(t is i for i in int_tensors):
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
