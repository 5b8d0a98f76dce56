"""2-bit gradient compression with an error-feedback residual (port of
``mxnet_tpu/gradient_compression.py``; reference:
src/kvstore/gradient_compression.h:38-132 and the quantize_2bit /
dequantize kernels of gradient_compression-inl.h):

  residual += grad
  code = 11 (-> +threshold) where residual >=  threshold
  code = 10 (-> -threshold) where residual <= -threshold
  code = 00 (->  0)         otherwise
  residual -= dequantize(code)

Sixteen values pack into one 32-bit word, value i in bits 30-2i..31-2i
(the first value in the highest bits), so the wire size is 1/16th of
fp32. Torch has no full ``uint32`` arithmetic: the words are built in
int64 and returned as int32 tensors holding the same 32 bits, so
``words.numpy().view(numpy.uint32)`` is the JAX package's uint32 array
bit for bit. The caller owns the residual (the kvstore keeps one per key
and worker).
"""

import numpy as np
import torch

__all__ = ["GradientCompression"]

_VALUES_PER_WORD = 16  # 2 bits x 16 = one 32-bit word


def _shifts(device):
    return torch.arange(30, -1, -2, dtype=torch.int64, device=device)


def _quantize_2bit(flat_grad, residual, threshold):
    """(packed int32 words, new residual) of a flat fp32 gradient."""
    t = torch.tensor(threshold, dtype=torch.float32, device=flat_grad.device)
    acc = residual + flat_grad
    pos = acc >= t
    neg = acc <= -t
    codes = torch.where(pos, 3, torch.where(neg, 2, 0)).to(torch.int64)
    zero = torch.zeros((), dtype=torch.float32, device=acc.device)
    emitted = torch.where(pos, t, torch.where(neg, -t, zero))
    new_residual = acc - emitted
    pad = (-codes.shape[0]) % _VALUES_PER_WORD
    if pad:
        codes = torch.cat([codes, codes.new_zeros(pad)])
    # the codes' bits are disjoint, so their sum is their bitwise or
    words = (codes.reshape(-1, _VALUES_PER_WORD)
             << _shifts(codes.device)).sum(dim=1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32), new_residual


def _dequantize_2bit(packed, threshold):
    """int32 words -> flat float32 of length 16 * len(packed)."""
    t = torch.tensor(threshold, dtype=torch.float32, device=packed.device)
    words = packed.to(torch.int64) & 0xFFFFFFFF
    codes = (words[:, None] >> _shifts(packed.device)) & 3
    zero = torch.zeros((), dtype=torch.float32, device=packed.device)
    vals = torch.where(codes == 3, t, torch.where(codes == 2, -t, zero))
    return vals.reshape(-1)


class GradientCompression(object):
    """The compression type and threshold, and stateless kernels; the
    caller owns the residual tensors."""

    def __init__(self, type="none", threshold=0.5):
        if type not in ("none", "2bit"):
            raise ValueError("Unsupported compression type %s "
                             "(supported: none, 2bit)" % type)
        if type == "2bit" and not threshold > 0:
            raise ValueError("threshold must be positive for 2bit "
                             "compression, got %s" % threshold)
        self.type = type
        self.threshold = float(threshold)

    @property
    def active(self):
        return self.type == "2bit"

    def get_compression_factor(self):
        return _VALUES_PER_WORD if self.active else 1

    def compressed_size(self, original_size):
        """Words needed for ``original_size`` fp32 values (reference
        GetCompressedSize, in elements, not bytes)."""
        if not self.active:
            return original_size
        return -(-original_size // _VALUES_PER_WORD)

    def init_residual(self, shape, dtype=torch.float32, device=None):
        return torch.zeros(int(np.prod(shape)), dtype=dtype, device=device)

    def quantize(self, grad, residual):
        """grad: a tensor of any shape; residual: a flat fp32 tensor of
        grad's size. Returns (packed words, updated residual)."""
        flat = grad.reshape(-1).to(torch.float32)
        return _quantize_2bit(flat, residual, self.threshold)

    def dequantize(self, packed, shape):
        n = int(np.prod(shape))
        return _dequantize_2bit(packed, self.threshold)[:n].reshape(shape)

    def compress_decompress(self, grad, residual):
        """One worker's step: quantize with error feedback, and return the
        reconstructed gradient and the new residual, which is what the
        receiving side sees after the wire."""
        packed, new_residual = self.quantize(grad, residual)
        return self.dequantize(packed, grad.shape), new_residual
