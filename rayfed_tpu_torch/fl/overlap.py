"""The delayed-gradient-averaging (DGA) correction of packed models.

``dga_correct(agg, cur, base) = agg + (cur − base)``: the delayed round
aggregate replaces the stale local base while the local progress made
since is kept.  The quorum loop (:mod:`rayfed_tpu_torch.fl.quorum`) folds a
straggler's missed round into its next starting point with it.

The pipelined round engine of the JAX package's ``fl/overlap.py``
(``PipelinedRoundRunner``, ``run_fedavg_rounds(overlap=True)``) is not
ported yet (ROADMAP.md, Queue A item 7).
"""

from __future__ import annotations

from typing import Any

import torch

from rayfed_tpu_torch.fl import fedavg
from rayfed_tpu_torch.fl.compression import PackedTree, torch_dtype


def dga_correct(agg: Any, cur: Any, base: Any) -> PackedTree:
    """``agg + (cur − base)`` on PackedTrees — the DGA staleness fix.

    ``agg`` is the delayed round aggregate, ``cur`` the party's current
    local model, ``base`` the local model its contribution was trained
    from.  The three buffers convert to f32, the sum runs as the JAX
    package's program computes it (``(agg + cur) − base``, two rounded f32
    ops: there is no product to contract) and casts once to ``cur``'s wire
    dtype, on ``cur``'s device.  Non-float (passthrough) leaves get the same
    elementwise recurrence.
    """
    for name, tree in (("agg", agg), ("cur", cur), ("base", base)):
        if not isinstance(tree, PackedTree):
            raise TypeError(
                f"dga_correct consumes PackedTrees; {name} is "
                f"{type(tree).__name__} — trainers must return "
                "fl.compress(updated, packed=True)"
            )
    if cur.spec != base.spec:
        raise ValueError(
            "dga_correct: cur/base pack specs differ — the trainer "
            "changed its tree structure mid-run"
        )
    if agg.spec.entries != cur.spec.entries or agg.spec.treedef != cur.spec.treedef:
        raise ValueError(
            "dga_correct: aggregate pack spec differs from the local "
            "model's — all parties must pack the identical structure"
        )
    device = fedavg._fold_device([cur.buf, agg.buf, base.buf])

    def f32(buf):
        return fedavg.as_tensor(buf, device).to(torch.float32)

    buf = (f32(agg.buf) + f32(cur.buf) - f32(base.buf)).to(torch_dtype(cur.spec.wire_dtype))
    passthrough = tuple(
        a + (c - b) for a, c, b in zip(agg.passthrough, cur.passthrough, base.passthrough)
    )
    return PackedTree(buf, passthrough, cur.spec)


class PipelinedRoundRunner:
    """Double-buffered FedAvg rounds (the JAX package's ``fl/overlap.py``):
    not ported yet."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        raise NotImplementedError(
            "PipelinedRoundRunner (overlap=True) is not ported yet "
            "(ROADMAP.md, Queue A item 7)"
        )
