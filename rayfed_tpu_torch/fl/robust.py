"""Byzantine-robust aggregation: bounded-influence alternatives to the mean.

The port of the JAX package's ``fl/robust.py``.  Plain FedAvg is a mean, so
one malicious (or merely broken) party can move the aggregate arbitrarily
far.  These estimators bound any single party's influence; each is an
``aggregator=`` callable over the parties' trees (torch tensors), run on the
device of its inputs, f32 throughout:

- :func:`tree_median`: coordinate-wise median (breakdown point 1/2);
- :func:`tree_trimmed_mean`: drop the ``trim`` largest and smallest values
  per coordinate and average the rest (tolerates ``trim`` Byzantine
  parties, Yin et al., 2018);
- :func:`krum` / :func:`multi_krum`: select the contribution(s) whose
  squared distance to their ``n − f − 2`` nearest peers is smallest
  (Blanchard et al., 2017): a selection rule, so the result is an actual
  party update.

The median of an even count is the mean of the two middle values, as
``jnp.median`` (a ``'midpoint'`` quantile) gives it, not ``torch.median``'s
lower one.  The trimmed mean sums its kept values in index order (XLA:CPU's
tree reduction over more than 32 of them,
:func:`rayfed_tpu_torch.ops.xla_cpu._tree_sum`) and multiplies by
``f32(1/k)``, as XLA:CPU compiles the JAX package's program: the median and
the trimmed mean equal its bytes, on the CPU and on the card alike.  Their
sorts read subnormals as zeros and their arithmetic flushes them, as that
program does (:mod:`rayfed_tpu_torch.ops.ftz`).

Krum's Gram product is a plain f32 product (elementwise, summed in f32) on
every device, never a TF32 tensor-core product whatever the global switch
says: Krum selects by argmin, and a lower-precision product could flip a
near-tied selection.  On the CPU the rest of the score is the JAX package's
program byte for byte: the row sums of squares and the scores' sums in
XLA:CPU's tree order (:func:`rayfed_tpu_torch.ops.xla_cpu._tree_sum`), and
the distances ``sq_i + sq_j − 2·G`` clamped at 0, all flushed.  The Gram
product itself holds the JAX package's to a tolerance: XLA:CPU hands the
``dot`` to a library kernel that it picks, with its summation order, from
the host's instruction set and cache sizes at run time (ROADMAP.md's
records), so no fixed order equals its bytes on every host.  The selection
is the same on inputs without near ties.
"""

from __future__ import annotations

from typing import Any, List, Sequence

import torch

from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.ops import ftz, xla_cpu


def _stack_leaves(trees: Sequence[Any]):
    trees = list(trees)
    if not trees:
        raise ValueError("need at least one contribution")
    stacked = tree_util.tree_map(
        lambda *leaves: torch.stack([torch.as_tensor(l).to(torch.float32) for l in leaves]), *trees,
    )
    return stacked, trees[0]


def _sorted(s: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``s`` sorted along ``dim`` as the JAX package's sort orders it on the
    CPU: a stable sort whose comparisons read subnormals as zeros (DAZ), the
    values themselves moved unchanged."""
    return torch.gather(s, dim, torch.argsort(ftz.flush(s), dim=dim, stable=True))


def _median_leaf(s: torch.Tensor) -> torch.Tensor:
    """The midpoint median over axis 0: ``(lo + hi)·0.5`` of the two middle
    sorted values (the same value twice for an odd count), subnormals
    flushed."""
    n = s.shape[0]
    srt = _sorted(s)
    lo, hi = srt[(n - 1) // 2], srt[n // 2]
    return ftz.mul(ftz.add(lo, hi), 0.5)


def _median_tree(stacked: Any) -> Any:
    return tree_util.tree_map(_median_leaf, stacked)


def _cast_like(out: Any, proto: Any) -> Any:
    """Cast float leaves back to the contribution dtype; int leaves keep the
    f32 result (a median or mean of ints is never truncated)."""
    return tree_util.tree_map(
        lambda m, p: m.to(p.dtype) if torch.as_tensor(p).is_floating_point() else m, out, proto,
    )


def tree_median(trees: Sequence[Any]) -> Any:
    """Coordinate-wise median of param trees (f32; float leaves cast back to
    their dtype, int leaves stay float)."""
    stacked, proto = _stack_leaves(trees)
    return _cast_like(_median_tree(stacked), proto)


def _tmean_tree(stacked: Any, trim: int) -> Any:
    def leaf(s):
        s = _sorted(s)
        kept = s[trim : s.shape[0] - trim] if trim else s
        k = kept.shape[0]
        if k == 1:
            # XLA's simplifier drops a one-element sum and the product with
            # 1: the value itself, unflushed.
            return kept[0]
        total = xla_cpu._tree_sum(kept.movedim(0, -1))
        return ftz.mul(total, 1.0 / k)

    return tree_util.tree_map(leaf, stacked)


def tree_trimmed_mean(trees: Sequence[Any], *, trim: int) -> Any:
    """Coordinate-wise ``trim``-trimmed mean: sort each coordinate across the
    ``n`` contributions, drop the ``trim`` smallest and largest values and
    average the remaining ``n − 2·trim``.  ``trim = 0`` is the plain mean."""
    trees = list(trees)
    n = len(trees)
    if trim < 0:
        raise ValueError(f"trim must be >= 0, got {trim}")
    if n - 2 * trim < 1:
        raise ValueError(
            f"trim={trim} leaves no contributions out of {n} "
            f"(need n - 2*trim >= 1)"
        )
    stacked, proto = _stack_leaves(trees)
    return _cast_like(_tmean_tree(stacked, int(trim)), proto)


def _gram_f32(flat: torch.Tensor) -> torch.Tensor:
    """``flat @ flat.T`` [n, n] as plain f32 products summed in f32, one
    row at a time (never a TF32 product)."""
    return torch.stack([ftz.flush(ftz.mul(flat, flat[i]).sum(dim=1)) for i in range(flat.shape[0])])


def _row_sums(a: torch.Tensor) -> torch.Tensor:
    """The sums over the last axis: XLA:CPU's tree order on the CPU, flushed
    (the JAX package's bytes), PyTorch's sum on the card."""
    if a.device.type == "cpu":
        return xla_cpu._tree_sum(a)
    return torch.sum(a, dim=-1)


def _scores(sq: torch.Tensor, gram: torch.Tensor, k: int) -> torch.Tensor:
    """Each party's sum of its ``k`` smallest squared distances to the
    others, ``sq_i + sq_j − 2·G`` clamped at 0 (each op flushed), from the
    rows' sums of squares and the Gram product."""
    d2 = torch.clamp(ftz.sub(ftz.add(sq[:, None], sq[None, :]), ftz.mul(2.0, gram)), min=0.0)
    # Push the self-distance past every real distance, then sum the k
    # smallest.
    d2 = d2 + torch.diag(torch.full((sq.shape[0],), float("inf"), device=sq.device))
    return _row_sums(torch.sort(d2, dim=1).values[:, :k])


def _krum_scores_flat(flat: torch.Tensor, k: int) -> torch.Tensor:
    return _scores(_row_sums(ftz.mul(flat, flat)), _gram_f32(flat), k)


def krum_scores(trees: Sequence[Any], *, num_byzantine: int) -> torch.Tensor:
    """Per-party Krum score: the sum of squared distances to the party's
    ``n − f − 2`` nearest peers (lower = more central).  ``f`` =
    ``num_byzantine``; requires ``n ≥ f + 3``."""
    trees = list(trees)
    n = len(trees)
    f = int(num_byzantine)
    if f < 0:
        raise ValueError(f"num_byzantine must be >= 0, got {f}")
    if n < f + 3:
        raise ValueError(f"Krum needs n >= f + 3 contributions (got n={n}, f={f})")
    k = n - f - 2
    flat = torch.stack([
        torch.cat([torch.as_tensor(l).reshape(-1).to(torch.float32) for l in tree_util.tree_leaves(t)])
        for t in trees
    ])
    return _krum_scores_flat(flat, k)


def krum(trees: Sequence[Any], *, num_byzantine: int) -> Any:
    """Blanchard et al.'s Krum: the single most central contribution (the
    lowest score), an actual party update."""
    trees = list(trees)
    scores = krum_scores(trees, num_byzantine=num_byzantine)
    return trees[int(torch.argmin(scores))]


def multi_krum(trees: Sequence[Any], *, num_byzantine: int, num_selected: int) -> Any:
    """The average of the ``num_selected`` lowest-score contributions."""
    trees = list(trees)
    m = int(num_selected)
    # Blanchard et al.'s bound: more than n − f − 2 selections can include
    # Byzantine updates.
    cap = len(trees) - int(num_byzantine) - 2
    if not 1 <= m <= cap:
        raise ValueError(
            f"num_selected must be in [1, n - f - 2] = [1, {cap}] "
            f"(n={len(trees)}, f={num_byzantine}), got {m}"
        )
    scores = krum_scores(trees, num_byzantine=num_byzantine)
    order = torch.argsort(scores, stable=True)
    chosen: List[Any] = [trees[int(i)] for i in order[:m]]
    from rayfed_tpu_torch.fl.fedavg import tree_average

    return tree_average(chosen)


__all__ = ["krum", "krum_scores", "multi_krum", "tree_median", "tree_trimmed_mean"]
