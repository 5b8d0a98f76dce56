"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. A wrapper takes the plain version only for tensors on the CPU;
on a CUDA tensor it launches its kernel or raises."""

from ._build import launches
from .flash_attention import (dense_decode_with_lse, flash_decode,
                              flash_decode_with_lse)
from .paged_decode import paged_attention, paged_attention_reference

__all__ = ["launches", "paged_attention", "paged_attention_reference",
           "flash_decode", "flash_decode_with_lse",
           "dense_decode_with_lse"]
