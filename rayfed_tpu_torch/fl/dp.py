"""Differential privacy for federated updates: clip + calibrated noise.

The port of the JAX package's ``fl/dp.py`` (DP-FedAvg, McMahan et al.,
2018): before an update leaves its silo, (1) bound its global L2 norm to
``clip_norm``, the sensitivity of the aggregate to any one party, and (2)
add Gaussian noise of ``noise_multiplier · clip_norm``.  Accounting is
deployment policy; this module is the mechanism, applied by every party to
its own update before the push.

Composes with :mod:`rayfed_tpu_torch.fl.secagg`: clip, noise, then mask, so
the server only sees the noised sum.  The transport rounds mask in the
shared-grid integer domain, where headroom is the grid's own concern; the
range discipline of :func:`secure_clip_for` and
:func:`check_secure_composition` is for the in-process fixed-point primitive
(:func:`rayfed_tpu_torch.fl.secagg.mask_update`), whose encode re-clips each
coordinate at its ``clip``.

Every function runs on the device of its inputs.  On CPU tensors
:func:`global_norm` is the JAX package's jitted program as XLA:CPU compiles
it (each leaf's sum of squares laid out by its tree reduction,
:func:`rayfed_tpu_torch.ops.xla_cpu.leaf_sum_sq`), so the norm and the
clipped tree equal its bytes; on the card the sums are PyTorch's.  Every
product, quotient and FMA flushes subnormals as the JAX package's program
does (:mod:`rayfed_tpu_torch.ops.ftz`).
:func:`privatize` draws its noise from an explicit ``torch.Generator`` (the
JAX package splits a PRNG key): the same scale and shape, another stream.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.ops import ftz, xla_cpu
from rayfed_tpu_torch.ops.fold import fma_ftz


def _leaf_sum_sq(leaf: torch.Tensor) -> torch.Tensor:
    x = leaf.to(torch.float32)
    if x.device.type == "cpu":
        return xla_cpu.leaf_sum_sq(x)
    return torch.sum(ftz.mul(x, x))


def global_norm(tree: Any) -> torch.Tensor:
    """Global L2 norm across every leaf of a tree (f32 0-d tensor on the
    leaves' device): the square root of the leaves' sums of squares, added
    in leaf order.  On the CPU a one-element leaf after the first is no
    reduction in XLA's program, and its square contracts with the add into
    one FMA."""
    leaves = tree_util.tree_leaves(tree)
    total: Optional[torch.Tensor] = None
    for leaf in leaves:
        x = torch.as_tensor(leaf)
        if total is not None and x.numel() == 1 and x.device.type == "cpu":
            xf = x.to(torch.float32).reshape(1)
            total = fma_ftz(xf, xf, total.reshape(1)).reshape(())
            continue
        s = _leaf_sum_sq(x)
        total = s if total is None else total + s.to(total.device)
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    if total.device.type == "cpu":
        # The correctly rounded square root (XLA's ``vsqrtss``); PyTorch's
        # CPU kernel is an ulp off on some inputs.
        return torch.from_numpy(np.sqrt(total.numpy().reshape(1)).astype(np.float32)).reshape(())
    return torch.sqrt(total)


def clip_by_global_norm(tree: Any, clip_norm: float) -> Tuple[Any, torch.Tensor]:
    """Scale ``tree`` so its global L2 norm is at most ``clip_norm``.

    Returns ``(clipped, original_norm)``; a tree already inside the ball is
    returned unscaled (standard DP-SGD clipping, not normalization).  Each
    leaf is multiplied in f32 by ``min(1, clip_norm / max(norm, 1e-12))``
    and cast back to its dtype.
    """
    norm = global_norm(tree)
    one = torch.ones((), dtype=torch.float32, device=norm.device)
    floor = torch.full((), 1e-12, dtype=torch.float32, device=norm.device)
    factor = torch.minimum(one, ftz.div(torch.full_like(one, clip_norm), torch.maximum(norm, floor)))
    clipped = tree_util.tree_map(
        lambda leaf: ftz.mul(leaf.to(torch.float32), factor.to(leaf.device)).to(leaf.dtype), tree,
    )
    return clipped, norm


def secure_clip_for(*, clip_norm: float, noise_multiplier: float, tail_sds: float = 6.0) -> float:
    """Fixed-point ``clip`` for ``fl.secagg.mask_update`` after
    :func:`privatize`: ``clip_norm`` plus ``tail_sds`` noise standard
    deviations (default 6: per-coordinate truncation probability ~1e-9),
    so the fixed-point encode does not re-clip the noise and bias the sum."""
    sigma = noise_multiplier * clip_norm
    return clip_norm + tail_sds * sigma


def check_secure_composition(
    *,
    clip_norm: float,
    noise_multiplier: float,
    secure_clip: float,
    tail_sds: float = 4.0,
) -> None:
    """Raise ``ValueError`` if ``mask_update(clip=secure_clip)`` would
    truncate DP noise: the fixed-point range must leave ``tail_sds`` noise
    standard deviations of headroom above ``clip_norm``."""
    needed = clip_norm + tail_sds * noise_multiplier * clip_norm
    if secure_clip < needed:
        raise ValueError(
            f"secure-aggregation fixed-point clip {secure_clip} would "
            f"truncate DP noise (clip_norm={clip_norm}, "
            f"sigma={noise_multiplier * clip_norm:.4g}): need >= {needed:.4g} "
            f"({tail_sds} standard deviations of headroom); use "
            f"secure_clip_for(...) or raise mask_update's clip="
        )


def privatize(
    tree: Any,
    generator: torch.Generator,
    *,
    clip_norm: float,
    noise_multiplier: float,
) -> Any:
    """Clip to ``clip_norm`` and add N(0, (noise_multiplier·clip_norm)²).

    The standard deviation is per coordinate: with every party clipped to
    the same sensitivity, the aggregate's noise is the Gaussian mechanism's
    at the chosen multiplier.  ``noise_multiplier=0`` is clipping only.
    ``generator``: a ``torch.Generator`` on the leaves' device, the party's
    own noise source (drawn leaf by leaf, in leaf order).
    """
    clipped, _ = clip_by_global_norm(tree, clip_norm)
    if noise_multiplier == 0.0:
        return clipped
    sigma = noise_multiplier * clip_norm
    leaves, treedef = tree_util.tree_flatten(clipped)
    noised = [
        (
            leaf.to(torch.float32)
            + sigma * torch.randn(leaf.shape, dtype=torch.float32, device=leaf.device, generator=generator)
        ).to(leaf.dtype)
        for leaf in leaves
    ]
    return tree_util.tree_unflatten(noised, treedef)


__all__ = [
    "check_secure_composition",
    "clip_by_global_norm",
    "global_norm",
    "privatize",
    "secure_clip_for",
]
