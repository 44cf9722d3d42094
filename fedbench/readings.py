"""The quantities that the metric readers report, one function each.

A quantity whose cells hold different bounds is reported under one name a
model kind (``round_s.llama``, ``round_s.resnet``): ``metrics/<name>.py``
picks the function here and sets ``KIND``, and a run reports a reader only
in the cells of its kind.  Each function takes the run's context
(``run.metric_context``) and returns None where the run has nothing to read.
"""

from __future__ import annotations

from fedbench import devtrace, roofline, spec
from fedbench.flops import fold, peaks


def round_s(ctx):
    """The window's wall time over the whole rounds completed in it, at the
    coordinator."""
    w = ctx["window"]
    return (w["t1"] - w["t0"]) / w["rounds"]


def peak_mem_gib(ctx):
    """The highest ``torch.cuda.max_memory_allocated`` of any party process
    over the run."""
    if ctx["platform"] != "gpu":
        return None
    return max(r["peak_bytes"] for r in ctx["reports"].values()) / 2**30


def local_s(ctx):
    """Mean ``local_s`` of the traced rounds at the coordinator
    (``run_fedavg_rounds(timings=)``): its own local steps' share of a round."""
    rows = ctx["timings"]
    return sum(t["local_s"] for t in rows) / len(rows) if rows else None


def exchange_s(ctx):
    """Mean ``push_s + agg_s`` of the traced rounds at the coordinator: the
    exchange and fold that the round waits for past its own local steps."""
    rows = ctx["timings"]
    return sum(t["push_s"] + t["agg_s"] for t in rows) / len(rows) if rows else None


def mfu(ctx):
    """The model FLOPs of every party's local steps in the traced rounds
    (``flops/<kind>.py``) over the rounds' wall time and the card's bfloat16
    peak, in %: the whole round's share of the chip, which bounds what any
    one kernel's roofline can claim."""
    tr = ctx["traced"]
    peak = peaks.lookup(peaks.FLOPS_BF16, ctx["device_name"])
    if tr is None or peak is None or ctx["platform"] != "gpu":
        return None
    wl = ctx["workload"]
    step = spec.kind_module("flops", ctx["config"]["kind"]).step_flops(ctx["config"], wl)
    flops = step * wl["local_steps"] * len(wl["parties"]) * tr["rounds"]
    return 100.0 * flops / ((tr["t1"] - tr["t0"]) * peak)


def send_ms(ctx):
    """Mean duration of a ``wire.send`` span of the flight recorder
    (``RAYFED_TRACE=1``), over every party's sends in the traced rounds."""
    tr = ctx["traced"]
    if tr is None:
        return None
    durs = [s[8] for s in ctx["spans"] if s[3] == "wire.send" and tr["t0"] <= s[7] < tr["t1"]]
    return 1e3 * sum(durs) / len(durs) if durs else None


def fold_ms(ctx):
    """The coordinator's ``agg.fold`` and ``agg.finalize`` spans, summed a
    round over the traced rounds."""
    tr = ctx["traced"]
    if tr is None:
        return None
    durs = [s[8] for s in ctx["spans"] if s[0] == ctx["coordinator"] and s[3] in ("agg.fold", "agg.finalize")
            and tr["t0"] <= s[7] < tr["t1"]]
    return 1e3 * sum(durs) / tr["rounds"] if durs else None


def fold_roofline(ctx):
    """The bytes the traced rounds' folds need (``flops/fold.py``
    ``round_bytes``: every contribution read once, the aggregate written
    once) at the HBM peak, over the device time of the fold kernels
    (``fold_chain``, ``fold_rows``) of every party, in %."""
    def need(_config, workload):
        elems = ctx["reports"][ctx["coordinator"]]["elems"]
        return 0, fold.round_bytes(len(workload["parties"]), elems)

    return roofline.share(ctx, ("fold_chain", "fold_rows"), need, per="round")


def device_idle(ctx):
    """The share of the traced rounds' wall time in which no party ran an
    operation on the card (the union of every party's kernels, copies and
    sets, on the host's clock), in %."""
    tr, ks = ctx["traced"], ctx["kernels"]
    if tr is None or ks is None or ctx["platform"] != "gpu":
        return None
    busy = devtrace.union(((s, s + d) for _p, _n, s, d in ks), tr["t0"], tr["t1"])
    return 100.0 * (1.0 - sum(e - s for s, e in busy) / (tr["t1"] - tr["t0"]))
