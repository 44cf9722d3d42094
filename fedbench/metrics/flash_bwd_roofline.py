"""flash_bwd_roofline: the same for ``flash_bwd_dq_wgmma`` and
``flash_bwd_dkv_wgmma`` together: the backward's five products over the
visible pairs (S again, dP, dV, dQ, dK), a pair of launches a call.
Layer: the kernels."""

from fedbench import roofline

TRACE, UNIT, LAYER, MOVES, KIND = 1, "%", "kernels", "round_s.llama", "llama"


def read(ctx):
    return roofline.share(ctx, ("flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma"), roofline.per_call("flash_call", True),
                          launches_per_call=2)
