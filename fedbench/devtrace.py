"""The device trace: ``torch.profiler`` in each party process, and its reduction.

:func:`start` and the profiler's ``stop`` run in a party process around the
traced rounds; :func:`read`, after the rounds, keeps only the device operations (kernels, copies,
sets) as ``(name, start, seconds)`` on the host's wall clock, so the party
processes' traces fall on one timeline.  The clock is tied by a marker
recorded at a known ``time.time_ns()``.  The rest reduces those lists:
the union of busy intervals, the time by operation and the idle gaps.
"""

from __future__ import annotations

import json
import os
import re
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "fedbench.clock"


def start(device):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    with record_function(MARKER):
        wall_ns = time.time_ns()
    return prof, wall_ns


def read(run, path: str):
    """The stopped profiler's device operations as ``[name, start_s, dur_s]``
    on the wall clock, or None where the marker is missing (no common clock)."""
    prof, wall_ns = run
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    marks = [e for e in events if e.get("name") == MARKER and e.get("ph") == "X"]
    if not marks:
        return None
    offset_us = wall_ns / 1e3 - marks[0]["ts"]
    return [[e["name"], (e["ts"] + offset_us) / 1e6, e.get("dur", 0.0) / 1e6]
            for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def union(intervals, lo: float, hi: float) -> list:
    """The union of ``(start, end)`` intervals clipped to ``[lo, hi]``, sorted."""
    out: list = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def attributed(kernels) -> list:
    """Each operation's share of the device's busy time: every stretch in
    which ``n`` operations overlap counts ``1/n`` to each.  Parties that
    share a card time-slice it, and the profiler's duration of an operation
    then holds the other processes' slices; the shares add up to the union.
    ``kernels``: ``[..., start, dur]`` rows; returns one share a row."""
    edges = []
    for i, k in enumerate(kernels):
        edges.append((k[-2], 1, i))
        edges.append((k[-2] + k[-1], 0, i))
    edges.sort()
    share = [0.0] * len(kernels)
    active: set = set()
    t_prev = None
    for t, opening, i in edges:
        if active and t > t_prev:
            each = (t - t_prev) / len(active)
            for j in active:
                share[j] += each
        t_prev = t
        if opening:
            active.add(i)
        else:
            active.discard(i)
    return share


def gaps(busy: list, lo: float, hi: float) -> list:
    """The idle stretches of ``[lo, hi]`` between the busy intervals."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and parameters."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, kept = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif depth == 0:
            if ch == "(":
                break
            kept.append(ch)
    return "".join(kept).strip()[:96] or name[:96]


def in_window(kernels, lo: float, hi: float) -> list:
    return [k for k in kernels if k[1] < hi and k[1] + k[2] > lo]
