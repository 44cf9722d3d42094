"""A kernel's share of its roofline, from the traced device operations."""

from __future__ import annotations

from fedbench import devtrace, spec
from fedbench.flops import peaks


def per_call(fn: str, *args):
    """The work of one call, by ``flops/<kind>.py``'s function ``fn``."""
    return lambda config, workload: getattr(spec.kind_module("flops", config["kind"]), fn)(config, workload, *args)


def share(ctx, names, work, *, launches_per_call: int = 1, per: str = "call"):
    """100 × (least time for the work) / (device time of the kernels whose
    name holds one of ``names``).  ``work(config, workload)`` gives the
    ``(flops, bytes)`` of one call (``per="call"``) or of one round
    (``per="round"``).  The device time is each kernel's attributed share
    (``devtrace.attributed``): with the parties time-slicing one card, a
    kernel's own span holds the others' slices.  None where no such kernel
    ran or the card has no published peak."""
    tr, ks = ctx["traced"], ctx["kernels"]
    if tr is None or ks is None or ctx["platform"] != "gpu":
        return None
    peak_f = peaks.lookup(peaks.FLOPS_BF16, ctx["device_name"])
    peak_b = peaks.lookup(peaks.HBM_BYTES_PER_S, ctx["device_name"])
    shares = ctx.get("shares") or devtrace.attributed(ks)
    ctx["shares"] = shares
    mine = [i for i, k in enumerate(ks) if any(n in k[1] for n in names) and tr["t0"] <= k[2] < tr["t1"]]
    if not mine or peak_f is None or peak_b is None:
        return None
    flops, nbytes = work(ctx["config"], ctx["workload"])
    count = len(mine) / launches_per_call if per == "call" else tr["rounds"]
    least = count * max(flops / peak_f, nbytes / peak_b)
    return 100.0 * least / sum(shares[i] for i in mine)
