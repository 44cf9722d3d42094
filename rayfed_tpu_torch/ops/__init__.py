"""Attention ops of the port: the dense reference and the flash kernel."""

from rayfed_tpu_torch.ops.attention import dot_product_attention
from rayfed_tpu_torch.ops.flash_attention import flash_attention

__all__ = ["dot_product_attention", "flash_attention"]
