"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. A wrapper takes the plain version only for tensors on the CPU;
on a CUDA tensor it launches its kernel or raises."""

from ._build import launches
from .flash_attention import (carry_block_reference, dense_attention_bwd,
                              dense_attention_with_lse,
                              dense_decode_with_lse, flash_attention,
                              flash_attention_bwd, flash_attention_with_lse,
                              flash_bwd_dkv, flash_bwd_dq, flash_carry_block,
                              flash_decode, flash_decode_splits,
                              flash_decode_with_lse)
from .paged_decode import (paged_attention, paged_attention_reference,
                           paged_decode_splits)

__all__ = ["launches", "paged_attention", "paged_attention_reference",
           "paged_decode_splits", "flash_decode_splits",
           "flash_attention", "flash_attention_with_lse",
           "flash_attention_bwd", "flash_bwd_dq", "flash_bwd_dkv",
           "dense_attention_with_lse",
           "dense_attention_bwd", "flash_decode", "flash_decode_with_lse",
           "dense_decode_with_lse", "flash_carry_block",
           "carry_block_reference"]
