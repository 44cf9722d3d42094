"""Quantities read from the program's own stage spans, one function each.

The flight recorder (``RAYFED_TRACE=1``) marks where a party's work runs:
its local step (``exec.call``, then ``exec.device`` until the card has
finished), the stages of a send (``wire.*``), the fold's staging and
launches (``agg.*``) and the codec (``codec.*``).  The functions here read
those spans of the traced rounds from the run's context
(``run.metric_context``; a span is a list in the recorder's field order)
and return None where the run holds none of them, as a program without
these spans does, and in a run off the card, which no cell makes.  A span is in the traced rounds when it lies wholly
inside them: the profiler's stop, just past their end, holds a party's
threads for a second or more, and a span that runs into it measures that.
"""

from __future__ import annotations

from fedbench import devtrace

# Span fields (the recorder's SPAN_FIELDS order).
PARTY, PHASE, PEER, T_START, DUR, DETAIL = 0, 3, 4, 7, 8, 10

# The program's spans of work: a stretch of the round that one of them
# covers is a party doing something.  Containers and waits are not work:
# driver.round, wire.send, wire.frame, agg.fold, mailbox.wait, exec.args,
# agg.wait, wire.loop_wait, and the benchmark's own trainer.train.
WORK_SPANS = (
    "exec.call", "exec.device", "codec.compress", "codec.decompress",
    "wire.device_wait", "wire.d2h", "wire.crc", "wire.socket",
    "wire.read", "wire.deliver", "wire.reassemble",
    "agg.stage", "agg.launch", "agg.finalize",
)
STEP_FN = "Trainer.train"  # the trainer method a party's local step runs in


def _end(s) -> float:
    return s[T_START] + s[DUR]


def _inside(ctx, a: float, b: float) -> bool:
    tr = ctx["traced"]
    return tr["t0"] <= a and b <= tr["t1"]


def _window(ctx):
    """The traced rounds of a run on the card, or None."""
    return ctx["traced"] if ctx["platform"] == "gpu" else None


def _traced(ctx, phases) -> list:
    """The spans of ``phases`` that lie in the traced rounds."""
    return [s for s in ctx["spans"] if s[PHASE] in phases and _inside(ctx, s[T_START], _end(s))]


def local_step_ms(ctx):
    """Mean time of a party's local step: from the start of a
    ``Trainer.train`` call on the host (``exec.call``) to the end of its
    ``exec.device`` span, when the card has finished the work the returned
    tensors depend on (the call's own end where there is none), over every
    party's calls in the traced rounds."""
    if _window(ctx) is None:
        return None
    step = [s for s in ctx["spans"] if s[PHASE] in ("exec.call", "exec.device")
            and (s[DETAIL] or {}).get("fn") == STEP_FN]
    device_end = {(s[PARTY], s[T_START]): _end(s) for s in step if s[PHASE] == "exec.device"}
    durs = []
    for call in (s for s in step if s[PHASE] == "exec.call"):
        end = _end(call)
        # exec.device opens at the instant the body returned: the call's end.
        match = [t for (p, t0), t in device_end.items() if p == call[PARTY] and abs(t0 - end) < 1e-6]
        end = match[0] if match else end
        if _inside(ctx, call[T_START], end):
            durs.append(end - call[T_START])
    return 1e3 * sum(durs) / len(durs) if durs else None


def transfer_ms(ctx):
    """Mean cost of a push: a ``wire.send`` span less the parts of it in
    which the sender waited for the card to finish the payload
    (``wire.device_wait`` spans of the same party and peer inside it), over
    every party's sends in the traced rounds."""
    if _window(ctx) is None:
        return None
    waits = _traced(ctx, ("wire.device_wait",))
    if not waits:
        return None
    durs = []
    for send in _traced(ctx, ("wire.send",)):
        a, b = send[T_START], _end(send)
        held = devtrace.union(((w[T_START], _end(w)) for w in waits
                               if (w[PARTY], w[PEER]) == (send[PARTY], send[PEER])), a, b)
        durs.append(send[DUR] - sum(e - s for s, e in held))
    return 1e3 * sum(durs) / len(durs) if durs else None


def agg_host_ms(ctx):
    """The coordinator's own fold work a round: its ``agg.stage`` (pinned
    host copies and their enqueue to the card), ``agg.launch`` and
    ``agg.finalize`` spans, summed over the traced rounds and divided by
    their number; the wait for the peers' bytes is left out."""
    tr = _window(ctx)
    if tr is None:
        return None
    spans = [s for s in _traced(ctx, ("agg.stage", "agg.launch", "agg.finalize"))
             if s[PARTY] == ctx["coordinator"]]
    if not any(s[PHASE] == "agg.launch" for s in spans):
        return None
    return 1e3 * sum(s[DUR] for s in spans) / tr["rounds"]


def idle_unattributed(ctx):
    """The share of the traced rounds' device-idle time (the stretches
    outside the union of every party's kernels, copies and sets) that no
    party's span of work (:data:`WORK_SPANS`) covers, in %: what the idle
    card waits on that the program's spans do not name."""
    tr, ks = _window(ctx), ctx["kernels"]
    if tr is None or ks is None or not _traced(ctx, ("exec.call",)):
        return None
    lo, hi = tr["t0"], tr["t1"]
    busy = devtrace.union(((s, s + d) for _p, _n, s, d in ks), lo, hi)
    idle = devtrace.gaps(busy, lo, hi)
    total = sum(b - a for a, b in idle)
    if total <= 0:
        return None
    work = devtrace.union(((s[T_START], _end(s)) for s in ctx["spans"] if s[PHASE] in WORK_SPANS), lo, hi)
    covered, j = 0.0, 0
    for a, b in idle:
        while j < len(work) and work[j][1] <= a:
            j += 1
        k = j
        while k < len(work) and work[k][0] < b:
            covered += min(b, work[k][1]) - max(a, work[k][0])
            k += 1
    return 100.0 * (total - covered) / total
