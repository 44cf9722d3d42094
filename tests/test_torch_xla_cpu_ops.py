"""Ops of the port whose CPU bytes follow XLA:CPU's program of the JAX
reference (``rayfed_tpu_torch/ops/xla_cpu.py``; CPU, f32, the tests' width
D = 64 and the wider 128 and 256).

- ``_rms_norm``: XLA sums a row of squares longer than 32 as a tree of
  zero-padded windows of 32 (half the padding before the row), a shorter
  row inside a jitted program as a chain of FMAs; it multiplies by f32(1/D)
  and adds eps (one FMA inside a jitted program) and takes ``rsqrt`` as the
  hardware estimate followed by two contracted Newton steps.  The port's
  CPU form reproduces both programs (``jitted=``); the norm's bytes equal
  the eager and the jitted reference's at every width of ``NORM_WIDTHS``
  (tolerance: byte identity).
- ``_quantize_kv``: XLA turns the scale's division by 127.0 into a product
  with f32(1/127); the port computes that product, and its scales equal the
  reference's byte for byte.
- ``fedavg.finalize_packed_quantized``: where the last block is short, XLA
  computes the loop's last few elements in scalar code and LLVM fuses
  ``acc − zp·W`` there; the port fuses the same elements.
- ``rope_tables``: XLA:CPU takes ``cos``/``sin`` from libm's ``cosf``/
  ``sinf`` and RoPE's frequencies from libm's ``powf`` (``1/powf(θ, e)`` op
  by op, ``powf(θ, −e)`` folded inside a jitted program); the port's CPU
  tables equal the eager and the jitted reference's byte for byte at every
  probed length.
- BERT's ``_layer_norm``: both programs sum rows in the tree order and
  take the mean as ``sum·f32(1/D)``; op by op the variance divides its sum
  by D, inside a jitted program it is ``fma(sum, f32(1/D), eps)`` and the
  affine tail ``fma(scale, t, bias)``; a row of at most 32 sums the
  variance's squares as an FMA chain (``jnp.var`` is one program).  The
  port's CPU norm equals the eager and the jitted reference's byte for byte
  at every width of ``LN_WIDTHS``.
- ``fl.dp.global_norm``'s per-leaf sum of squares
  (``xla_cpu.leaf_sum_sq``): every dimension longer than 32 is cut into
  zero-padded windows of 32, a shorter one is one window; each window and
  the remainder add over XLA's loop nest as LLVM optimized it (a narrow
  rows loop as vector lanes, a dimension padded by one element at its end
  with that index last); a leaf with no long dimension fuses its squares
  (FMAs, in lanes where the rows loop is vectorized).  The forms ROADMAP.md
  Queue C once listed open are tier-1 tests (narrow widths of the norm,
  ``NARROW_LEAVES``, 300 random trees); ``_probe_open`` counts them.
- The gradient through the norm is torch.rsqrt's (the exact forward value
  rides on it), held against ``jax.grad`` at the model tests' 1e-5.
- Every form flushes subnormals as XLA:CPU does (DAZ, and FTZ with
  tininess after rounding): the norms on the operands of
  ``tests/test_torch_subnormals_models.py``, ``rsqrt``, ``div_const`` and
  the cosine and sine on subnormal inputs, RoPE's frequencies where ``θ^e``
  nears 2^128, and Krum's rows' sums of squares and its scores given the
  reference's Gram product (the Gram product itself follows the host's
  library kernel and is held to a tolerance there).
- ``_probe`` checks each of ``xla_cpu``'s assumptions against the installed
  jaxlib on this host and names the one that fails; run ``JAX_PLATFORMS=cpu
  python -m tests.test_torch_xla_cpu_ops`` to print it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayfed_tpu.models import llama as jax_llama
from rayfed_tpu_torch.models import llama

D = 64


def _rows(seed, shape=(2, 7, D)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * rng.uniform(0.05, 8.0)).astype(np.float32)


@pytest.mark.parametrize("seed", range(6))
def test_rms_norm_bytes_equal_xla(seed):
    x = _rows(seed)
    scale = np.random.default_rng(100 + seed).standard_normal(D).astype(np.float32)
    want = np.asarray(jax.jit(jax_llama._rms_norm, static_argnums=2)(jnp.asarray(x), jnp.asarray(scale), 1e-5))
    got = llama._rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5, jitted=True).numpy()
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("width", [128, 256])
def test_rms_norm_bytes_equal_xla_at_wider_rows(width):
    for seed in range(3):
        x = _rows(seed, (2, 7, width))
        scale = np.random.default_rng(200 + seed).standard_normal(width).astype(np.float32)
        want = np.asarray(jax.jit(jax_llama._rms_norm, static_argnums=2)(jnp.asarray(x), jnp.asarray(scale), 1e-5))
        got = llama._rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5, jitted=True).numpy()
        assert got.tobytes() == want.tobytes(), seed


NORM_WIDTHS = [8, 16, 48, 64, 96, 128, 160, 384, 768, 1024, 2048, 4096]


def _reference_norm(x, scale, jitted):
    args = (jnp.asarray(x), jnp.asarray(scale), 1e-5)
    if jitted:
        return np.asarray(jax.jit(jax_llama._rms_norm, static_argnums=2)(*args))
    return np.asarray(jax_llama._rms_norm(*args))


@pytest.mark.parametrize("jitted", [False, True], ids=["eager", "jitted"])
@pytest.mark.parametrize("width", NORM_WIDTHS)
def test_rms_norm_bytes_equal_the_reference_at_every_width(width, jitted):
    """64 seeded rows: the port's norm equals the reference's op by op (its
    prefill and ``apply_llama``) and inside one jitted program (its decode
    and train steps), byte for byte."""
    x = _rows(width, (64, width))
    scale = np.random.default_rng(300 + width).standard_normal(width).astype(np.float32)
    got = llama._rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5, jitted=jitted).numpy()
    assert got.tobytes() == _reference_norm(x, scale, jitted).tobytes()


def test_rms_norm_bytes_equal_xla_in_bf16():
    import ml_dtypes

    x = _rows(7).astype(ml_dtypes.bfloat16)
    scale = np.ones(D, np.float32)
    want = np.asarray(jax.jit(jax_llama._rms_norm, static_argnums=2)(jnp.asarray(x), jnp.asarray(scale), 1e-5))
    got = llama._rms_norm(torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16),
                          torch.from_numpy(scale), 1e-5, jitted=True)
    assert got.view(torch.uint16).numpy().tobytes() == want.view(np.uint16).tobytes()


def test_rms_norm_gradient_follows_the_reference():
    x = _rows(3)
    scale = np.random.default_rng(4).standard_normal(D).astype(np.float32)
    gx, gs = jax.grad(lambda a, s: jnp.sum(jax_llama._rms_norm(a, s, 1e-5) ** 2), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(scale))
    tx = torch.from_numpy(x).requires_grad_()
    ts = torch.from_numpy(scale).requires_grad_()
    (llama._rms_norm(tx, ts, 1e-5) ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(gs), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", range(3))
def test_quantize_kv_scales_equal_xla(seed):
    x = _rows(seed, (2, 7, 2, 16))
    wq, ws = jax.jit(jax_llama._quantize_kv)(jnp.asarray(x))
    q, s = llama._quantize_kv(torch.from_numpy(x))
    assert s.numpy().tobytes() == np.asarray(ws).tobytes()
    assert q.numpy().tobytes() == np.asarray(wq).tobytes()


@pytest.mark.parametrize("with_ref", [False, True])
@pytest.mark.parametrize("nb,tail", [(2, t) for t in range(16)] + [(1, 9), (5, 11)])
def test_quantized_finalize_bytes_equal_xla(nb, tail, with_ref):
    """``finalize_packed_quantized`` over a padded block grid whose last
    block is short: XLA:CPU fuses ``acc − zp·W`` in the elements its loop
    leaves to scalar code (``xla_cpu._scalar_tail``), and the port's
    bytes equal the reference's at every element."""
    from rayfed_tpu.fl import fedavg as jf
    from rayfed_tpu_torch.fl import fedavg as tf

    ce = 1024
    n = (nb - 1) * ce + 16 * 20 + tail
    for seed in range(4):
        rng = np.random.default_rng(1000 * nb + 10 * tail + seed)
        scales = rng.uniform(1e-3, 1e-2, nb).astype(np.float32)
        zps = rng.uniform(50, 200, nb).astype(np.float32)
        acc = rng.integers(0, 6 * 255, size=nb * ce).astype(np.int32)
        ref = rng.normal(size=n).astype(np.float32) if with_ref else None
        want = np.asarray(jf.finalize_packed_quantized(acc, scales, zps, 6.0, n, ce, np.float32, ref=ref))
        got = tf.finalize_packed_quantized(torch.from_numpy(acc), scales, zps, 6.0, n, ce, "float32", ref=ref)
        assert got.numpy().tobytes() == want.tobytes(), seed


ROPE_LENGTHS = [1, 7, 8, 9, 100, 2048]
ROPE_HALF_DIMS = [8, 64]


def _angles(t, half, theta=500000.0):
    """RoPE angles built as both packages build them (f32)."""
    e = (np.arange(0, 2 * half, 2, dtype=np.float32) / np.float32(2 * half)).astype(np.float32)
    freqs = (np.float32(1.0) / np.power(np.float32(theta), e)).astype(np.float32)
    return (np.arange(t, dtype=np.float32)[:, None] * freqs[None, :]).astype(np.float32)


@pytest.mark.parametrize("half", ROPE_HALF_DIMS)
@pytest.mark.parametrize("t", ROPE_LENGTHS)
def test_cos_sin_bytes_equal_xla(t, half):
    from rayfed_tpu_torch.ops import xla_cpu

    a = _angles(t, half)
    for ours, theirs in ((xla_cpu.cos, jnp.cos), (xla_cpu.sin, jnp.sin)):
        want = np.asarray(jax.jit(theirs)(jnp.asarray(a)))
        assert ours(torch.from_numpy(a)).numpy().tobytes() == want.tobytes(), theirs.__name__


@pytest.mark.parametrize("half", ROPE_HALF_DIMS)
@pytest.mark.parametrize("t", ROPE_LENGTHS)
def test_rope_tables_bytes_equal_the_reference(t, half):
    """Eager, as the JAX package's prefill builds them, and jitted with the
    positions traced, as its decode step does (``folded=True``)."""
    dh, theta = 2 * half, 500000.0
    pos = np.arange(t, dtype=np.int32)
    cases = ((False, jax_llama.rope_tables(jnp.asarray(pos), dh, theta)),
             (True, jax.jit(lambda p: jax_llama.rope_tables(p, dh, theta))(jnp.asarray(pos))))
    for folded, want in cases:
        got = llama.rope_tables(torch.from_numpy(pos).long(), dh, theta, folded=folded)
        for g, w in zip(got, want):
            assert g.numpy().tobytes() == np.asarray(w).tobytes(), folded


LN_WIDTHS = [64, 128, 384, 768, 1024, 4096]


def _reference_layer_norm(x, scale, bias, jitted):
    from rayfed_tpu.models import bert as jax_bert

    args = (jnp.asarray(x), {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, 1e-12)
    if jitted:
        return np.asarray(jax.jit(jax_bert._layer_norm, static_argnums=2)(*args))
    return np.asarray(jax_bert._layer_norm(*args))


def _ln_inputs(width):
    rng = np.random.default_rng(width)
    x = (rng.standard_normal((64, width)) * 3).astype(np.float32)
    return x, rng.standard_normal(width).astype(np.float32), rng.standard_normal(width).astype(np.float32)


@pytest.mark.parametrize("jitted", [False, True], ids=["eager", "jitted"])
@pytest.mark.parametrize("width", LN_WIDTHS)
def test_layer_norm_bytes_equal_the_reference(width, jitted):
    """64 seeded rows (normals × 3, seeded scale and bias, eps 1e-12): BERT's
    norm equals the reference's op by op and inside one jitted program (its
    split encoder step), byte for byte."""
    from rayfed_tpu_torch.models import bert

    x, scale, bias = _ln_inputs(width)
    p = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
    got = bert._layer_norm(torch.from_numpy(x), p, 1e-12, jitted=jitted).numpy()
    assert got.tobytes() == _reference_layer_norm(x, scale, bias, jitted).tobytes()


def test_layer_norm_gradient_is_torchs():
    from rayfed_tpu_torch.models import bert

    x, scale, bias = _ln_inputs(64)
    tx = torch.from_numpy(x).requires_grad_()
    p = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
    (bert._layer_norm(tx, p, 1e-12, jitted=True) ** 2).sum().backward()
    ux = torch.from_numpy(x).requires_grad_()
    mean = ux.mean(-1, keepdim=True)
    ref = (ux - mean) * torch.rsqrt(ux.var(-1, keepdim=True, unbiased=False) + 1e-12)
    ((ref * p["scale"] + p["bias"]) ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), ux.grad.numpy(), rtol=1e-5, atol=1e-5)


# Subnormals of both signs, the smallest normals and the boundary 2^-126.
EDGES = np.array([1e-39, -3e-39, 1e-45, -1e-45, 5.9e-39, -1.1754942e-38, 2.0 ** -126, -(2.0 ** -126), 0.0, -0.0],
                 np.float32)


def _probe(size=200_000):
    """Elements, per assumption of ``xla_cpu``, where the installed jaxlib's
    program and the port's form differ (0 everywhere while each holds), and
    the reduce window read from the compiled HLO at D = 64."""
    import re

    from rayfed_tpu.fl import fedavg as jf
    from rayfed_tpu.fl import robust as jax_robust
    from rayfed_tpu_torch.fl import fedavg as tf
    from rayfed_tpu_torch.fl import robust
    from rayfed_tpu_torch.ops import xla_cpu
    from tests.test_torch_subnormals_models import _krum_flat
    from tests.test_torch_subnormals_models import _operands as _subnormal_operands

    out = {}
    hlo = jax.jit(jax_llama._rms_norm, static_argnums=2).lower(
        jnp.zeros((2, 7, D), jnp.float32), jnp.zeros(D, jnp.float32), 1e-5).compile().as_text()
    windows = {int(w) for w in re.findall(r"reduce-window\([^\n]*window=\{size=(?:\d+x)*(\d+) ", hlo)}
    out["REDUCE_WINDOW"] = int(windows != {xla_cpu.REDUCE_WINDOW})
    bad = 0
    for width in list(range(2, 65)) + [96, 160, 384, 768, 1000, 2048, 4096, 4099]:
        xs = _rows(width, (64, width))
        ones = np.ones(width, np.float32)
        for jitted in (False, True):
            got = llama._rms_norm(torch.from_numpy(xs), torch.from_numpy(ones), 1e-5, jitted=jitted).numpy()
            bad += int(np.sum(got.view(np.uint32) != _reference_norm(xs, ones, jitted).view(np.uint32)))
    out["rms_norm widths 2-64 and wider (eager, jitted)"] = bad
    bad = 0
    for width in [2, 4, 16, 32, 33, 100, 1000] + LN_WIDTHS:
        x, scale, bias = _ln_inputs(width)
        for jitted in (False, True):
            got = xla_cpu.layer_norm(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
                                     1e-12, jitted).numpy()
            want = _reference_layer_norm(x, scale, bias, jitted)
            bad += int(np.sum(got.view(np.uint32) != want.view(np.uint32)))
    out["layer_norm (eager, jitted)"] = bad
    bad = 0
    for width in (8, 64, 4096):
        x, scale = _subnormal_operands(width, width)
        for jitted in (False, True):
            got = xla_cpu.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5, jitted).numpy()
            bad += int(np.sum(got.view(np.uint32) != _reference_norm(x, scale, jitted).view(np.uint32)))
    for width in [5, 32, 33] + LN_WIDTHS:
        x, scale = _subnormal_operands(width, 1000 + width, balanced=True)
        bias = np.zeros(width, np.float32)
        for jitted in (False, True):
            got = xla_cpu.layer_norm(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
                                     1e-12, jitted).numpy()
            want = _reference_layer_norm(x, scale, bias, jitted)
            bad += int(np.sum(got.view(np.uint32) != want.view(np.uint32)))
    out["rms_norm, layer_norm with subnormals (DAZ, FTZ after rounding)"] = bad
    bad = 0
    for n, d in ((4, 1000), (5, 50000), (12, 4096)):
        flat = _krum_flat(n, d)
        k = n - max(1, (n - 3) // 3) - 2
        sq_ref = np.array(jax.jit(lambda a: jnp.sum(a ** 2, axis=1))(flat))
        gram_ref = np.array(jax.jit(lambda a: jnp.matmul(a, a.T, precision=jax.lax.Precision.HIGHEST))(flat))
        sq = robust._row_sums(robust.ftz.mul(torch.from_numpy(flat), torch.from_numpy(flat))).numpy()
        bad += int(np.sum(sq.view(np.uint32) != sq_ref.view(np.uint32)))
        got = robust._scores(torch.from_numpy(sq_ref), torch.from_numpy(gram_ref), k).numpy()
        bad += int(np.sum(got.view(np.uint32) != np.asarray(jax_robust._krum_scores_flat(flat, k)).view(np.uint32)))
    out["krum sq, and scores given the reference's Gram"] = bad
    f = jax.jit(lambda x: jnp.sum(x.astype(jnp.float32) ** 2))
    bad = 0
    for i, shape in enumerate([(3, 3, 64, 64), (3, 1000), (40, 3), (7, 9), (100,), (33,), (57,), (64, 48),
                               (512, 10), (2, 33, 40), (65543,), (9, 32), (16, 16), (1,), (64, 9), (64, 32)]):
        x = _rows(i, shape)
        want = np.asarray(f(jnp.asarray(x)))
        bad += int(xla_cpu.leaf_sum_sq(torch.from_numpy(x)).numpy().view(np.uint32) != want.view(np.uint32))
    out["leaf_sum_sq (window layout, FMA chain)"] = bad
    x = np.random.default_rng(0).lognormal(0.0, 6.0, size).astype(np.float32)
    x[:len(EDGES)] = EDGES
    want = np.asarray(jax.jit(jax.lax.rsqrt)(jnp.asarray(x)))
    out["rsqrt"] = int(np.sum(xla_cpu.rsqrt(torch.from_numpy(x)).numpy().view(np.uint32) != want.view(np.uint32)))
    want = np.asarray(jax.jit(lambda a: a / 127.0)(jnp.asarray(x)))
    got = xla_cpu.div_const(torch.from_numpy(x), 127.0).numpy()
    out["div_const"] = int(np.sum(got.view(np.uint32) != want.view(np.uint32)))
    bad, ce = 0, 1024
    for tail in range(xla_cpu.VECTOR_WIDTH * xla_cpu.UNROLL):
        n = ce + 16 * 20 + tail
        rng = np.random.default_rng(tail)
        scales = rng.uniform(1e-3, 1e-2, 2).astype(np.float32)
        zps = rng.uniform(50, 200, 2).astype(np.float32)
        acc = rng.integers(0, 6 * 255, size=2 * ce).astype(np.int32)
        want = np.asarray(jf.finalize_packed_quantized(acc, scales, zps, 6.0, n, ce, np.float32))
        got = tf.finalize_packed_quantized(torch.from_numpy(acc), scales, zps, 6.0, n, ce, "float32").numpy()
        bad += int(np.sum(got.view(np.uint32) != want.view(np.uint32)))
    out["VECTOR_WIDTH, UNROLL"] = bad
    a = np.random.default_rng(1).uniform(-1e4, 1e4, size).astype(np.float32)
    a[:len(EDGES)] = EDGES
    for name, ours, theirs in (("cos", xla_cpu.cos, jnp.cos), ("sin", xla_cpu.sin, jnp.sin)):
        want = np.asarray(jax.jit(theirs)(jnp.asarray(a)))
        out[name] = int(np.sum(ours(torch.from_numpy(a)).numpy().view(np.uint32) != want.view(np.uint32)))
    bad = 0
    for dh in range(8, 257, 8):
        # 3e38: θ^e nears 2^128, and the eager quotient underflows.
        for theta in (10000.0, 500000.0, 123456.7, 3e38):
            e = torch.arange(0, dh, 2, dtype=torch.float32) / dh
            for folded, fn in ((False, lambda: 1.0 / theta ** (jnp.arange(0, dh, 2, dtype=jnp.float32) / dh)),
                               (True, jax.jit(lambda: 1.0 / theta ** (jnp.arange(0, dh, 2, dtype=jnp.float32) / dh)))):
                want = np.asarray(fn())
                bad += int(np.sum(xla_cpu.rope_freqs(e, theta, folded).numpy().view(np.uint32) != want.view(np.uint32)))
    out["rope_freqs (eager, folded)"] = bad
    return out


# The forms ROADMAP.md Queue C once listed open: BERT's norm at widths 5 to 8
# (the variance's FMA chain), a leaf's sum of squares whose reduce window is
# narrow (the rows loop LLVM vectorizes: lanes, a tree, a scalar remainder),
# one padded by one element at its end (that index summed last) or small
# enough to fuse its squares (FMA lanes), and the DP norm over random trees.
LN_NARROW_WIDTHS = [5, 6, 7, 8]
NARROW_LEAVES = [(64, b) for b in range(2, 9)] + [
    (64, 3, 1), (46, 25, 7), (64, 30, 5), (35, 127, 7), (26, 63), (67, 63), (63, 7),
    (36, 63, 62), (150, 171, 191), (32, 7), (2, 5), (5, 2, 5), (30, 5), (16, 30, 2),
]
NORM_TREES, NORM_TREE_CHUNKS = 300, 3


def _layer_norm_mismatches(width, jitted):
    from rayfed_tpu_torch.models import bert

    x, scale, bias = _ln_inputs(width)
    p = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
    got = bert._layer_norm(torch.from_numpy(x), p, 1e-12, jitted=jitted).numpy()
    return int(np.sum(got.view(np.uint32) != _reference_layer_norm(x, scale, bias, jitted).view(np.uint32)))


def _leaf_sum_sq_mismatches(shape, seeds):
    from rayfed_tpu_torch.ops import xla_cpu

    f = jax.jit(lambda x: jnp.sum(x.astype(jnp.float32) ** 2))
    bad = 0
    for seed in range(seeds):
        rng = np.random.default_rng(seed)
        x = (rng.standard_normal(shape) * rng.uniform(0.01, 3)).astype(np.float32)
        want = np.asarray(f(jnp.asarray(x)))
        bad += int(xla_cpu.leaf_sum_sq(torch.from_numpy(x)).numpy().view(np.uint32) != want.view(np.uint32))
    return bad


def _global_norm_mismatches(seeds):
    """Random trees of 1 to 5 leaves, ranks 0-3, dimensions 1-69."""
    from rayfed_tpu.fl import dp as jax_dp
    from rayfed_tpu_torch.fl import dp

    bad = 0
    for seed in seeds:
        rng = np.random.default_rng(seed)
        shapes = [tuple(int(d) for d in rng.integers(1, 70, rng.integers(0, 4))) for _ in range(rng.integers(1, 6))]
        tree = {f"l{i}": (rng.standard_normal(s) * rng.uniform(0.01, 3)).astype(np.float32)
                for i, s in enumerate(shapes)}
        want = np.asarray(jax_dp.global_norm(tree))
        got = dp.global_norm({k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}).numpy()
        bad += int(got.view(np.uint32) != want.view(np.uint32))
    return bad


def _probe_open(seeds=6):
    """Elements where a form of ``xla_cpu`` that ROADMAP.md Queue C listed
    open differs from the installed jaxlib's program: the layer norm at
    widths 5 to 8, a leaf's sum of squares over ``NARROW_LEAVES``, and
    ``fl.dp.global_norm`` over random trees."""
    n_ln = 2 * 64 * sum(LN_NARROW_WIDTHS)
    return {
        f"layer_norm widths 5-8 (eager, jitted; of {n_ln} elements)":
            sum(_layer_norm_mismatches(w, j) for w in LN_NARROW_WIDTHS for j in (False, True)),
        f"leaf_sum_sq narrow windows (of {len(NARROW_LEAVES) * seeds} sums)":
            sum(_leaf_sum_sq_mismatches(s, seeds) for s in NARROW_LEAVES),
        f"global_norm of random trees, ranks 0-3, dims 1-69 (of {NORM_TREES})":
            _global_norm_mismatches(range(NORM_TREES)),
    }


@pytest.mark.parametrize("jitted", [False, True], ids=["eager", "jitted"])
@pytest.mark.parametrize("width", LN_NARROW_WIDTHS)
def test_layer_norm_bytes_equal_the_reference_at_narrow_widths(width, jitted):
    assert _layer_norm_mismatches(width, jitted) == 0


@pytest.mark.parametrize("shape", NARROW_LEAVES, ids=lambda s: "x".join(map(str, s)))
def test_leaf_sum_sq_bytes_equal_the_reference(shape):
    assert _leaf_sum_sq_mismatches(shape, seeds=3) == 0


@pytest.mark.parametrize("chunk", range(NORM_TREE_CHUNKS))
def test_global_norm_of_random_trees_equals_the_reference(chunk):
    per = NORM_TREES // NORM_TREE_CHUNKS
    assert _global_norm_mismatches(range(chunk * per, (chunk + 1) * per)) == 0


def test_xla_cpu_assumptions_hold_on_this_jaxlib():
    probe = _probe(size=50_000)
    assert not any(probe.values()), f"assumptions of ops/xla_cpu.py that fail: {probe}"


def _reference_gram(flat):
    return np.asarray(jax.jit(lambda a: jnp.matmul(a, a.T, precision=jax.lax.Precision.HIGHEST))(flat))


def _gram_order(n, d):
    """The summation order of the installed jaxlib's f32 Gram product on
    this host, read by cancellation: row r holds +2^60 at column 0, −2^60
    at column j and ones elsewhere, the last row ones, so ``d − G[r, −1]``
    is the number of columns in the smallest partial sum that holds both.
    Returns (lanes, block): the stride of the chain through column 0, and
    the columns summed into one block before the next block's add."""
    big, sizes = np.float32(2.0 ** 60), {}
    for j0 in range(1, 9, n - 1):
        f = np.ones((n, d), np.float32)
        js = range(j0, min(9, j0 + n - 1))
        for r, j in enumerate(js):
            f[r, 0], f[r, j] = big, -big
        g = _reference_gram(f)
        sizes.update({j: int(d - g[r, n - 1]) for r, j in enumerate(js)})
    lanes = min([j for j, v in sizes.items() if v == 2] or [1])
    return lanes, sizes[max(1, lanes // 2)]


def _gram_emulated(flat, lanes, block):
    """``flat @ flat.T`` as ``lanes`` chains of FMAs over the columns of
    each ``block`` (column k in lane k mod ``lanes``), the lanes added as a
    tree of neighbours, the blocks' sums added in order."""
    from rayfed_tpu_torch.ops import ftz
    from rayfed_tpu_torch.ops.fold import fma_ftz

    f = torch.from_numpy(flat)
    n, d = f.shape
    a, b = f[:, None, :].expand(n, n, d).reshape(n * n, d), f[None].expand(n, n, d).reshape(n * n, d)
    total = None
    for b0 in range(0, d, block):
        acc = torch.zeros(n * n, lanes)
        for k in range(b0, min(d, b0 + block), lanes):
            m = min(lanes, d - k, b0 + block - k)
            acc[:, :m] = fma_ftz(a[:, k:k + m].contiguous(), b[:, k:k + m].contiguous(), acc[:, :m].contiguous())
        while acc.shape[1] > 1:
            acc = ftz.add(acc[:, 0::2], acc[:, 1::2])
        total = acc[:, 0] if total is None else ftz.add(total, acc[:, 0])
    return total.reshape(n, n).numpy()


def _gram_probe():
    """The Gram product's order on this host (lanes, block) at Krum's test
    shapes, and the entries an emulation of that order gets right, beside
    the same order with the lanes of the AVX2 kernels (2) and of a plain
    chain (1): the order decides the bytes, and the host decides the
    order."""
    out = {}
    for n, d in ((4, 1000), (5, 50000), (12, 4096)):
        lanes, block = _gram_order(n, d)
        flat = (np.random.default_rng(n).standard_normal((n, d)) * 0.1).astype(np.float32)
        want = _reference_gram(flat).view(np.uint32)
        hits = {k: int(np.sum(_gram_emulated(flat, k, block).view(np.uint32) == want)) for k in (lanes, 2, 1)}
        out[f"gram {n}x{d}: lanes {lanes}, block {block}; entries equal (of {n * n}) by lanes"] = hits
    return out


if __name__ == "__main__":
    for name, count in _probe().items():
        print(f"{name}: {count}")
    print("known open until closed (ROADMAP.md Queue C; each must print 0):")
    for name, count in _probe_open().items():
        print(f"  {name}: {count}")
    print("Krum's Gram product: the host's order (held to a tolerance, not probed as an assumption):")
    for name, hits in _gram_probe().items():
        print(f"  {name}: {hits}")
