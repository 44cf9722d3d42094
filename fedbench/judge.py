"""Decides ``correct``: the program's readings against the plain reference's.

Training cells compare, for every party, the first ``follow_steps`` local
steps of the round that set-up drove through the window's own call:

- ``loss_gap``: the largest ``|loss − ref| / |ref|`` over the steps;
- ``grad1_gap``: by the worst leaf, the gap between the norms of the first
  gradient as the optimizer got it and the reference's, over the larger of
  that leaf's reference norm and the median leaf's;
- ``change_gap``: the same for the params' change over the followed steps;
- ``grad1_diff``: by the worst leaf, the norm of the difference between the
  program's first gradient and the reference's, over the same denominator:
  a lower-precision base moves it first, where gaps of norms average its
  error away;
- ``agg_mismatch``: elements of the aggregate that any party holds after
  the window that differ from the plain fold of the last round's uploads
  (exact: limit 0).

Leaves whose reference gradient is under a thousandth of the median
nonzero leaf's are left out (a LoRA ``scale``, which the model uses
detached; LoRA A at step 1, whose gradient is exactly zero while B is).
"""

from __future__ import annotations

import math
import statistics

import torch

RULE = 1e-3


def tree_leaves(tree, prefix: str = ""):
    """``(path, tensor)`` of a tree of dicts, lists and tuples, in a fixed order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def leaf_norms(tree, minus=None) -> dict:
    """Each leaf's norm (of ``tree − minus`` where given), in float64."""
    with torch.no_grad():
        if minus is None:
            return {k: float(v.double().norm()) for k, v in tree_leaves(tree)}
        base = dict(tree_leaves(minus))
        return {k: float((v.double() - base[k].double()).norm()) for k, v in tree_leaves(tree)}


def counted(ref_norms: dict) -> set:
    """The leaves that count: reference norm at least ``RULE`` times the
    median of the nonzero ones."""
    nonzero = [v for v in ref_norms.values() if v > 0]
    if not nonzero:
        return set()
    floor = RULE * statistics.median(nonzero)
    return {k for k, v in ref_norms.items() if v >= floor and v > 0}


def worst_leaf_gap(prog: dict, ref: dict, keep: set) -> float:
    if not keep:
        return math.inf
    med = statistics.median(ref[k] for k in keep)
    return max(abs(prog.get(k, math.inf) - ref[k]) / max(ref[k], med) for k in keep)


def follow_gaps(prog: dict, ref: dict) -> dict:
    """The three training numbers, worst over the parties."""
    loss = grad1 = change = 0.0
    for party, r in ref.items():
        p = prog[party]
        if len(p["losses"]) != len(r["losses"]):
            return {"loss_gap": math.inf, "grad1_gap": math.inf, "change_gap": math.inf}
        loss = max([loss] + [abs(a - b) / abs(b) for a, b in zip(p["losses"], r["losses"])])
        grad1 = max(grad1, worst_leaf_gap(p["grad1"], r["grad1"], counted(r["grad_norms"][0])))
        moved = {k: max(step[k] for step in r["grad_norms"]) for k in r["grad_norms"][0]}
        change = max(change, worst_leaf_gap(p["change"], r["change"], counted(moved)))
    return {"loss_gap": loss, "grad1_gap": grad1, "change_gap": change}


def grad1_diff(prog: dict, ref: dict) -> float:
    """By the worst counted leaf, the norm of the difference between the
    program's first gradient and the reference's, over the larger of the
    leaf's and the median leaf's reference norm; worst over the parties."""
    worst = 0.0
    for party, r in ref.items():
        keep = counted(r["grad_norms"][0])
        if not keep:
            return math.inf
        med = statistics.median(r["grad1"][k] for k in keep)
        for k in keep:
            got, want = prog[party].get(k), r["grad1_tensors"][k]
            if got is None or got.shape != want.shape:
                return math.inf
            gap = float((got.double() - want.double().cpu()).norm()) / max(r["grad1"][k], med)
            worst = max(worst, gap)
    return worst


def fold_mismatch(uploads: list, finals: list, fold) -> int:
    """Elements of any party's aggregate that differ, bit for bit, from the
    plain fold of the uploads."""
    want = fold(uploads)
    worst = 0
    for got in finals:
        if got.shape != want.shape or got.dtype != want.dtype:
            return want.numel()
        worst = max(worst, int((got.view(torch.int16) != want.view(torch.int16)).sum()))
    return worst


def verdict(values: dict, limits: dict) -> tuple:
    """``(correct, checks)``: every number within its limit, each beside it."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
