"""flash_fwd_roofline: the least time the card could take for the work of
the traced ``flash_fwd_wgmma`` calls (``flops/llama.py`` ``flash_call``:
two products over the visible pairs at the bfloat16 peak, or the bytes at
the HBM peak, whichever is longer), over their device time.  Layer: the
kernels."""

from fedbench import roofline

TRACE, UNIT, LAYER, MOVES, KIND = 1, "%", "kernels", "round_s.llama", "llama"


def read(ctx):
    return roofline.share(ctx, ("flash_fwd_wgmma",), roofline.per_call("flash_call", False))
