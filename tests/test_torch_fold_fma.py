"""The exact fused multiply-add of ``rayfed_tpu_torch.ops.fold`` on the CPU.

``fma`` is the plain version of the fold kernel (``csrc/fold_fma.cu``): one
rounding of ``a·b + c``.  Held against numpy's exact product and sum in
f64, then rounded once to f32 through round-to-odd (tolerance: byte
identity), against a two-op chain (which it must differ from somewhere), and
for the dispatch rule: CPU tensors run the plain version, other devices
launch the kernel or raise, with no fallback.
"""

import numpy as np
import pytest
import torch

from rayfed_tpu_torch.ops import fold


def _exact_fma(a, b, c):
    """a·b + c in exact rational arithmetic, rounded once to the nearest f32
    (ties to even)."""
    from fractions import Fraction

    out = np.empty(len(b), np.float32)
    for i, (x, y) in enumerate(zip(b, c)):
        q = Fraction(float(a)) * Fraction(float(x)) + Fraction(float(y))
        f = np.float32(float(q))
        cands = [f, np.nextafter(f, np.float32(np.inf)), np.nextafter(f, np.float32(-np.inf))]
        dist = [abs(Fraction(float(g)) - q) for g in cands]
        best = min(dist)
        ties = [g for g, d in zip(cands, dist) if d == best]
        out[i] = min(ties, key=lambda g: int(np.array(g).view(np.int32)) & 1)
        if q == 0:
            out[i] = f  # the sign of an exact zero: the IEEE sum's, as float() gives it
    return out


def test_fma_is_the_correctly_rounded_fused_multiply_add():
    rng = np.random.default_rng(0)
    b = rng.standard_normal(3000).astype(np.float32)
    c = rng.standard_normal(3000).astype(np.float32)
    c[:8] = [0.0, -0.0, 1e-40, -1e-40, 3.0, -3.0, 1e30, -1e-30]
    a = np.float32(1.7)
    got = fold.fma(torch.tensor(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    want = _exact_fma(a, b, c)
    assert got.tobytes() == want.tobytes()
    assert np.any(got != (a * b + c))  # a two-op chain rounds twice


def test_fold_forms_on_the_cpu():
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(5000, generator=gen).to(torch.bfloat16)
    y = torch.randn(5000, generator=gen)
    acc = torch.randn(5000, generator=gen)
    w, v = torch.tensor(2.3), torch.tensor(0.9)
    want = fold.fma(w, x.float(), acc)
    got = acc.clone()
    assert fold.fold_fma_(got, w, x) is got and torch.equal(got, want)
    assert torch.equal(fold.fold_fma_pair(w, x, v, y), fold.fma(w, x.float(), v * y))


def test_fold_fma_refuses_a_device_without_the_kernel():
    """Not a CPU tensor: the kernel runs or the call raises (here no card)."""
    meta = torch.empty(8, device="meta")
    w = torch.empty((), device="meta")
    with pytest.raises(RuntimeError, match="cuda"):
        fold.fold_fma_(meta, w, meta)
    with pytest.raises(RuntimeError, match="cuda"):
        fold.fold_fma_pair(w, meta, w, meta)
