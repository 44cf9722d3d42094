"""Subnormals in the model programs and Krum's score: the port's CPU forms
flush them as the JAX package's programs do.

XLA runs its CPU programs with DAZ and FTZ set (``ops/ftz.py``): a subnormal
operand reads as a zero of its sign, and a result that is tiny after
rounding writes one.  Held here byte for byte against the JAX package, on
operands made from a numpy seed with subnormals of both signs, a row scaled
near 2^-126, and a row built so that the norm's last product lands exactly
at 2^-126 − 2^-150 (tiny after rounding: the reference writes a zero where
gradual underflow would round up to 2^-126):

- Llama's ``_rms_norm`` (``rayfed_tpu/models/llama.py:244``) at D = 8, 64
  and 4096, op by op and inside one jitted program, f32 and bf16;
- BERT's ``_layer_norm`` (``rayfed_tpu/models/bert.py:99``) at every width
  of ``LN_WIDTHS``, op by op and jitted;
- Krum (``rayfed_tpu/fl/robust.py:135``): the rows' sums of squares, and
  the scores given the reference's own Gram product, byte for byte; the
  port's Gram product within 1e-6·Σ_k|x_ik·x_jk| and its order of scores
  equal.  The Gram's bytes are XLA:CPU's library kernel's, whose summation
  order follows the host (ROADMAP.md's records).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from rayfed_tpu.fl import robust as jrb
from rayfed_tpu.models import bert as jax_bert
from rayfed_tpu.models import llama as jax_llama
from rayfed_tpu_torch.fl import robust as trb
from rayfed_tpu_torch.models import bert, llama

BELOW_ONE = np.float32(1 - 2 ** -24)
# The boundary row's special elements: times r = 2^-10 they are ±2^-126.
SPECIAL = np.float32(2.0 ** -116)
RMS_EPS, LN_EPS = 1e-5, 1e-12
RMS_WIDTHS = [8, 64, 4096]
LN_WIDTHS = [64, 128, 384, 768, 1024, 4096]


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _mismatches(got, want):
    return int(np.sum(_bits(got) != _bits(want)))


def _boundary_row(d, rng, balanced):
    """A row whose squares sum to exactly ``d``·2^20 (so RMSNorm's and, with
    ``balanced``, LayerNorm's rsqrt is 2^-10) with three elements ±2^-116:
    one 2^11, the rest ±2^10 (``balanced``: with −2^10 twice more, summing
    to 0), specials at columns 1, 2 and 3."""
    row = np.full(d, 2.0 ** 10, np.float32)
    signs = np.where(np.arange(d - 6) % 2 == 0, 1.0, -1.0) if balanced else rng.choice([-1.0, 1.0], d - 6)
    row[6:] *= rng.permutation(signs).astype(np.float32)
    row[0] = 2.0 ** 11
    row[4:6] = -(2.0 ** 10) if balanced else row[4:6]
    row[1:4] = [SPECIAL, -SPECIAL, SPECIAL]
    return row


def _operands(d, seed, balanced=False):
    """[6, d] f32: normals with subnormals of both signs; a row scaled by
    1e-37 (values about 2^-126, some subnormal); a row uniform in ±[2^-127,
    2^-125]; normals times 1e-20 (squares that underflow); the boundary
    row; normals with a block of subnormals.  The scale: normals, with
    1 − 2^-24 at the boundary row's special columns."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((6, d)).astype(np.float32)
    x[0, 3], x[0, -1] = 1e-39, -1e-45
    x[1, 5 % d], x[1, d // 2] = -3e-39, 5.9e-39
    x[2] *= np.float32(1e-37)
    x[3] = (rng.uniform(2.0 ** -127, 2.0 ** -125, d) * rng.choice([-1.0, 1.0], d)).astype(np.float32)
    x[4] = _boundary_row(d, rng, balanced)
    x[5] *= np.float32(1e-20)
    x[5, : d // 4] = (rng.standard_normal(d // 4) * 1e-39).astype(np.float32)
    scale = rng.standard_normal(d).astype(np.float32)
    scale[1:4] = BELOW_ONE
    return x, scale


def _jax_rms(x, scale, jitted):
    args = (jnp.asarray(x), jnp.asarray(scale), RMS_EPS)
    if jitted:
        return np.asarray(jax.jit(jax_llama._rms_norm, static_argnums=2)(*args))
    return np.asarray(jax_llama._rms_norm(*args))


def _torch_in(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x)


def _torch_out(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("jitted", [False, True], ids=["eager", "jitted"])
@pytest.mark.parametrize("width", RMS_WIDTHS)
def test_rms_norm_flushes_as_the_reference(width, jitted, dtype):
    x, scale = _operands(width, width)
    if dtype == "bf16":
        x = x.astype(ml_dtypes.bfloat16)
        # Subnormal bf16 codes of both signs.
        x.view(np.uint16)[0, :3] = [0x0001, 0x807F, 0x0040]
    want = _jax_rms(x, scale, jitted)
    # The boundary row's specials: ±2^-126 times 1 − 2^-24 is tiny, a zero.
    assert not np.asarray(want[4, 1:4], np.float32).any()
    got = _torch_out(llama._rms_norm(_torch_in(x), torch.from_numpy(scale), RMS_EPS, jitted=jitted))
    assert _mismatches(got, want) == 0


def test_rms_norm_gradient_stays_pytorchs():
    """The flushed value rides on PyTorch's ops: the gradient is theirs."""
    x, scale = _operands(64, 1)
    x = x[[0, 1, 4]]
    tx, ts = torch.from_numpy(x).requires_grad_(), torch.from_numpy(scale).requires_grad_()
    (llama._rms_norm(tx, ts, RMS_EPS, jitted=True) ** 2).sum().backward()
    ux, us = torch.from_numpy(x).requires_grad_(), torch.from_numpy(scale).requires_grad_()
    ((ux * torch.rsqrt((ux * ux).mean(-1, keepdim=True) + RMS_EPS) * us) ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), ux.grad.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ts.grad.numpy(), us.grad.numpy(), rtol=1e-5, atol=1e-5)


def _jax_ln(x, scale, bias, jitted):
    args = (jnp.asarray(x), {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, LN_EPS)
    if jitted:
        return np.asarray(jax.jit(jax_bert._layer_norm, static_argnums=2)(*args))
    return np.asarray(jax_bert._layer_norm(*args))


@pytest.mark.parametrize("jitted", [False, True], ids=["eager", "jitted"])
@pytest.mark.parametrize("width", LN_WIDTHS)
def test_layer_norm_flushes_as_the_reference(width, jitted):
    x, scale = _operands(width, 1000 + width, balanced=True)
    bias = np.random.default_rng(width).standard_normal(width).astype(np.float32)
    bias[1:4] = 0.0
    want = _jax_ln(x, scale, bias, jitted)
    assert not want[4, 1:4].any()
    p = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
    got = bert._layer_norm(torch.from_numpy(x), p, LN_EPS, jitted=jitted).numpy()
    assert _mismatches(got, want) == 0


KRUM_SHAPES = [(4, 1000), (5, 50000), (7, 300000), (12, 4096)]


def _krum_flat(n, d):
    """Seeded updates: normals, subnormals of both signs in row 0, a row of
    1e-20s (squares that underflow) and one outlier row."""
    rng = np.random.default_rng(n * d)
    flat = (rng.standard_normal((n, d)) * 0.1).astype(np.float32)
    flat[0, :4] = [1e-39, -3e-39, 1e-45, -5.9e-39]
    flat[1] *= np.float32(1e-20)
    flat[-1] += np.float32(3.0)
    return flat


@pytest.mark.parametrize("n,d", KRUM_SHAPES, ids=lambda v: str(v))
def test_krum_scores_follow_the_reference(n, d):
    """``sq`` and the scores given the reference's Gram product are its
    bytes; the port's Gram product lies within 1e-6·Σ_k|x_ik·x_jk| of the
    reference's, its scores within 1e-6, and Krum's order is the same."""
    flat = _krum_flat(n, d)
    f = max(1, (n - 3) // 3)
    k = n - f - 2
    sq_ref = np.array(jax.jit(lambda a: jnp.sum(a ** 2, axis=1))(flat))
    gram_ref = np.array(jax.jit(lambda a: jnp.matmul(a, a.T, precision=jax.lax.Precision.HIGHEST))(flat))
    want = np.asarray(jrb._krum_scores_flat(flat, k))
    tflat = torch.from_numpy(flat)
    sq = trb._row_sums(trb.ftz.mul(tflat, tflat))
    assert _mismatches(sq.numpy(), sq_ref) == 0
    assert _mismatches(trb._scores(torch.from_numpy(sq_ref), torch.from_numpy(gram_ref), k).numpy(), want) == 0
    # Relative to Σ_k |x_ik·x_jk|: a sum's error in any order scales with it.
    gram = trb._gram_f32(tflat).numpy()
    mag = np.abs(flat).astype(np.float64) @ np.abs(flat).astype(np.float64).T
    assert np.all(np.abs(gram - gram_ref) <= 1e-6 * mag)
    got = trb._krum_scores_flat(tflat, k).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.argsort(got, kind="stable").tolist() == np.argsort(want, kind="stable").tolist()
