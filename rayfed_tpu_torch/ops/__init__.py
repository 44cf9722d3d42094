"""Attention ops of the port: the dense reference, the flash kernels, and
the sequence-parallel forms over a party mesh (ring, flash ring, zigzag
ring, Ulysses)."""

from rayfed_tpu_torch.ops.attention import dot_product_attention, mha
from rayfed_tpu_torch.ops.flash_attention import flash_attention
from rayfed_tpu_torch.ops.ring_attention import (
    make_ring_attention,
    ring_attention,
    ring_flash_attention,
    zigzag_ring_flash_attention,
)
from rayfed_tpu_torch.ops.ulysses import make_ulysses_attention, ulysses_attention

__all__ = [
    "dot_product_attention",
    "mha",
    "flash_attention",
    "ring_attention",
    "ring_flash_attention",
    "zigzag_ring_flash_attention",
    "make_ring_attention",
    "ulysses_attention",
    "make_ulysses_attention",
]
