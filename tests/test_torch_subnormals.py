"""Subnormals in the round's float programs: the port flushes them as the
JAX package's programs do.

XLA runs its CPU programs with DAZ and FTZ set: a subnormal f32 operand reads
as a zero of its sign, and a result that is tiny after rounding (x86's rule)
writes a zero of its sign.  Every float program of the round is held here
against its JAX twin byte for byte on the CPU, on operands with subnormals of
both signs, products that underflow, and results that land just below
2^-126 (some round up to it, some are tiny): the streamed step, the one-shot
chain and its finalize, the stripe finalize, error feedback, the
compressed-domain finalize, the codec's quantize and dequantize, the server
step and resync, DP clipping, and the robust reducers.  The kernel's bytes
are held to these plain versions on the card (``tests/test_torch_fold_gpu.py``,
``chip_smoke.py`` ``phase_fold``).
"""

import numpy as np
import pytest
import torch

from rayfed_tpu_torch.fl import compression as tc
from rayfed_tpu_torch.fl import dp as tdp
from rayfed_tpu_torch.fl import fedavg as tf
from rayfed_tpu_torch.fl import quantize as tq
from rayfed_tpu_torch.fl import robust as trb
from rayfed_tpu_torch.ops import fold, ftz

N = 4099
TINY = np.float32(2.0 ** -126)
# 1 − 2^-24: times 2^-126 the exact product is 2^-126 − 2^-150, tiny after
# rounding (x86 flushes it) though gradual underflow rounds it up to 2^-126.
BELOW_ONE = float(np.float32(1 - 2 ** -24))
WIRES = {"f32": torch.float32, "bf16": torch.bfloat16}
OUTS = {"f32-out": torch.float32, "bf16-out": torch.bfloat16}


def _edge_values(n, seed, scale=1.0):
    """Normals with subnormals of both signs, values whose products
    underflow, values at and just above 2^-126, signed zeros, and blocks of
    tiny normals and of ~1e-20 mixed in."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * scale).astype(np.float32)
    edge = np.array([1e-40, -1e-40, 3e-39, -3e-39, 1e-45, -1e-45, 1e-20, -1e-20, TINY, -TINY,
                     np.float32(TINY * (1 + 2 ** -23)), 1e-19, 0.0, -0.0, 5.9e-39, -1.1754942e-38], np.float32)
    x[: len(edge)] = edge
    for mag in (1e-38, 2e-20):
        idx = rng.choice(np.arange(len(edge), n), size=n // 8, replace=False)
        x[idx] = (rng.standard_normal(len(idx)) * mag).astype(np.float32)
    return x


def _boundary(n, w):
    """Operands x whose products ``w·x`` sweep 2^-126 ± 64 ulps: the exact
    product lands on both sides of the flush, some rounding up to 2^-126."""
    k = np.arange(n) % 129 - 64
    base = np.float32(TINY / np.float64(np.float32(w)))
    x = (base * (1 + k * 2.0 ** -24)).astype(np.float32)
    return np.where(np.arange(n) % 2 == 0, x, -x).astype(np.float32)


def _raw(a):
    if isinstance(a, torch.Tensor):
        return a.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _jwire(x, wire):
    import jax.numpy as jnp

    return jnp.asarray(x).astype(jnp.dtype(tc.dtype_name(wire)))


def test_the_reference_flushes_after_rounding():
    """What the port reproduces: a jitted product of (1 − 2^-24) and 2^-126
    is a zero of its sign in the JAX package's arithmetic, and so it is in
    the port's helpers, the fold's FMA and the model programs' forms."""
    import jax

    x = np.array([TINY, -TINY, 1e-40], np.float32)
    ref = jax.jit(lambda a, b: a * b)(np.float32(BELOW_ONE), x)
    assert _raw(ref) == np.array([0.0, -0.0, 0.0], np.float32).tobytes()
    assert _raw(ftz.mul(BELOW_ONE, torch.from_numpy(x))) == _raw(ref)
    got = fold.fma_ftz(torch.tensor(BELOW_ONE), torch.from_numpy(x), torch.zeros(3))
    assert _raw(got) == _raw(ref)
    # The model programs flush too: BERT's jitted affine tail
    # ``fma(scale, t, bias)`` at t = ±2^-126 (a row whose norm is exact).
    from rayfed_tpu.models import bert as jax_bert
    from rayfed_tpu_torch.ops import xla_cpu

    row = np.array([[2.0 ** 11, -(2.0 ** 10), -(2.0 ** 10), 2.0 ** -116, -(2.0 ** -116), 0.0]], np.float32)
    scale = np.array([1, 1, 1, BELOW_ONE, BELOW_ONE, 1], np.float32)
    bias = np.zeros(6, np.float32)
    want = jax.jit(jax_bert._layer_norm, static_argnums=2)(row, {"scale": scale, "bias": bias}, 1e-12)
    assert _raw(np.asarray(want)[0, 3:5]) == np.array([0.0, -0.0], np.float32).tobytes()
    got = xla_cpu.layer_norm(torch.from_numpy(row), torch.from_numpy(scale), torch.from_numpy(bias), 1e-12,
                             jitted=True)
    assert _raw(got) == _raw(want)


@pytest.mark.parametrize("w", [1.7, BELOW_ONE, 0.5, 1e-20], ids=["1.7", "below-one", "0.5", "1e-20"])
@pytest.mark.parametrize("wire", sorted(WIRES))
@pytest.mark.parametrize("operands", ["edges", "boundary"])
def test_streamed_step_flushes_as_the_reference(wire, w, operands):
    """``fl/streaming.py:63`` ``_accum_kernel`` (one step ``acc + w·x``)
    against the fold's step form."""
    from rayfed_tpu.fl import streaming as jss

    acc = _edge_values(N, 1)
    x = _edge_values(N, 2) if operands == "edges" else _boundary(N, w)
    if operands == "boundary":
        acc[::3] = 0.0
    xw = torch.from_numpy(x).to(WIRES[wire])
    ref = jss._accum_kernel(N, "float32", tc.dtype_name(WIRES[wire]))(acc, _jwire(x, WIRES[wire]), 0,
                                                                       np.float32(w))
    got = fold.fold_fma_(torch.from_numpy(acc.copy()), w, xw)
    assert _raw(got) == _raw(ref)


CHAIN_WEIGHTS = {"fractions": [1.7, 2.3, 0.9], "below-one": [BELOW_ONE] * 3, "tiny-first": [1e-20, 3.0, 1.0]}


@pytest.mark.parametrize("total", ["sum", "huge"])
@pytest.mark.parametrize("weights", sorted(CHAIN_WEIGHTS))
@pytest.mark.parametrize("out", sorted(OUTS))
@pytest.mark.parametrize("wire", sorted(WIRES))
@pytest.mark.parametrize("k", [1, 2, 3])
def test_one_shot_chain_flushes_as_the_reference(k, wire, out, weights, total):
    """``fl/fedavg.py:83`` ``_packed_reduce_jit`` (products, FMAs, the
    division; a huge divisor makes quotients underflow) against the chain
    form."""
    from rayfed_tpu.fl import fedavg as jf

    ws = CHAIN_WEIGHTS[weights][:k]
    xs = [_edge_values(N, 10 + i) for i in range(k)]
    xs[0][N // 2:] = _boundary(N - N // 2, ws[0])
    tot = float(np.float32(sum(ws))) if total == "sum" else 3.5e37
    ref = jf._packed_reduce_jit(tc.dtype_name(OUTS[out]))(tuple(_jwire(x, WIRES[wire]) for x in xs),
                                                          np.asarray(ws, np.float32), np.float32(tot))
    got = fold.fold_chain([torch.from_numpy(x).to(WIRES[wire]) for x in xs], ws, tot, OUTS[out])
    assert _raw(got) == _raw(ref)


@pytest.mark.parametrize("total", [1.7, 3.0, 1e30, float(np.float32(1 + 2 ** -23))])
@pytest.mark.parametrize("out", sorted(OUTS))
def test_stripe_finalize_flushes_as_the_reference(out, total):
    """``fl/fedavg.py:139`` ``_stripe_finalize_jit``: quotients that
    underflow, and accumulators that divide to just below 2^-126."""
    from rayfed_tpu.fl import fedavg as jf

    acc = _edge_values(N, 3)
    acc[N // 2:] = _boundary(N - N // 2, 1.0 / total)
    name = tc.dtype_name(OUTS[out])
    ref = jf._stripe_finalize_jit(N - 5, name)(acc, np.float32(total))
    got = tf.finalize_packed_stripe(torch.from_numpy(acc), total, N - 5, name)
    assert _raw(got) == _raw(ref)


@pytest.mark.parametrize("wire", sorted(WIRES))
def test_error_feedback_flushes_as_the_reference(wire):
    """``fl/compression.py:275`` ``_ef_kernel``: the corrected buffer and the
    carried residual."""
    from rayfed_tpu.fl import compression as jc

    buf, resid = _edge_values(N, 4), _edge_values(N, 5, 1e-3)
    ref_w, ref_r = jc._ef_kernel(tc.dtype_name(WIRES[wire]))(buf, resid)
    got_w, got_r = tc._ef_step(torch.from_numpy(buf), torch.from_numpy(resid), WIRES[wire])
    assert _raw(got_w) == _raw(ref_w) and _raw(got_r) == _raw(ref_r)


CE = 512


def _grid_vectors(seed, subnormal_scales=True):
    nb = -(-N // CE)
    rng = np.random.default_rng(seed)
    scales = np.full(nb, 2e-38, np.float32)
    scales[::2] = np.float32(3e-3)
    if subnormal_scales:
        scales[1] = np.float32(1e-41)
    zps = rng.integers(100, 150, nb).astype(np.float32)
    return scales, zps


@pytest.mark.parametrize("w", [3.0, 1.7])
@pytest.mark.parametrize("with_ref", [False, True], ids=["abs", "delta"])
@pytest.mark.parametrize("out", sorted(OUTS))
def test_quantized_finalize_flushes_as_the_reference(out, with_ref, w):
    """``fl/fedavg.py:304`` ``_quant_finalize_jit``: the rescale with tiny
    and subnormal block scales, and the reference add."""
    import jax.numpy as jnp

    from rayfed_tpu.fl import fedavg as jf

    nb = -(-N // CE)
    acc = np.random.default_rng(6).integers(-300, 300, nb * CE).astype(np.int32)
    scales, zps = _grid_vectors(6)
    ref = _edge_values(N, 7) if with_ref else None
    jout = jnp.float32 if out == "f32-out" else jnp.bfloat16
    want = jf.finalize_packed_quantized(jnp.asarray(acc), scales, zps, w, N, CE, jout, ref=ref)
    got = tf.finalize_packed_quantized(torch.from_numpy(acc), scales, zps, w, N, CE, tc.dtype_name(OUTS[out]),
                                       ref=ref)
    assert _raw(got) == _raw(want)


@pytest.mark.parametrize("with_ref", [False, True], ids=["abs", "delta"])
@pytest.mark.parametrize("wire", ["uint8", "int8"])
def test_codec_flushes_as_the_reference(wire, with_ref):
    """``fl/quantize.py:473`` ``_quantize_kernel`` (the codes and the
    residual, its FMA included) and ``:507`` ``_dequantize_kernel`` (f32 and
    bf16 out), with subnormal and tiny values in the buffer, the reference
    and the carried residual, and tiny block scales."""
    import jax.numpy as jnp

    from rayfed_tpu.fl import quantize as jq

    scales, zps = _grid_vectors(8, subnormal_scales=False)
    if wire == "int8":
        zps = zps - 128
    jg = jq.QuantGrid(scales, zps, CE, N, wire, "delta")
    tg = tq.QuantGrid(scales, zps, CE, N, wire, "delta")
    buf, resid = _edge_values(N, 8, 1e-2), _edge_values(N, 9, 1e-4)
    ref = _edge_values(N, 7)
    jref = jnp.asarray(ref) if with_ref else jnp.zeros(0, jnp.float32)
    want_q, want_r = jq._quantize_kernel(CE, N, wire, with_ref)(jnp.asarray(buf), jref, jnp.asarray(jg.scales),
                                                               jnp.asarray(jg.zps), jnp.asarray(resid))
    got_q, got_r = tq._quantize_codes(torch.from_numpy(buf), torch.from_numpy(ref) if with_ref else None,
                                      torch.from_numpy(resid), tg)
    assert _raw(got_q) == _raw(want_q) and _raw(got_r) == _raw(want_r)
    scales, zps = _grid_vectors(8)  # dequantize reads a subnormal scale too
    if wire == "int8":
        zps = zps - 128
    jg = jq.QuantGrid(scales, zps, CE, N, wire, "delta")
    tg = tq.QuantGrid(scales, zps, CE, N, wire, "delta")
    for out in ("float32", "bfloat16"):
        want = jq._dequantize_kernel(CE, N, wire, out, with_ref)(want_q, jref, jnp.asarray(jg.scales),
                                                                jnp.asarray(jg.zps))
        got = tq._dequantize_codes(got_q, torch.from_numpy(ref) if with_ref else None, tg, out)
        assert _raw(got) == _raw(want), out


@pytest.mark.parametrize("kind, hyper", [("momentum", (0.7, 0.9)), ("momentum", (1.0, 0.5)),
                                         ("fedac", (0.6, 1.3, 0.25)), ("fedac", (1.0, 0.7, 0.5))])
def test_server_step_and_resync_flush_as_the_reference(kind, hyper):
    """``fl/fedavg.py:365`` ``server_step_kernel`` and ``:433``
    ``server_resync_kernel``, FedAC and momentum."""
    from rayfed_tpu.fl import fedavg as jf

    x, avg, st = _edge_values(N, 11), _edge_values(N, 12), _edge_values(N, 13)
    avg[N // 2:] = x[N // 2:] - _boundary(N - N // 2, 1.0)  # deltas at the boundary
    want = jf.server_step_kernel(kind, hyper)(x, avg, st)
    got = tf.server_step_kernel(kind, hyper)(torch.from_numpy(x), torch.from_numpy(avg), torch.from_numpy(st))
    assert _raw(got) == _raw(want)
    want = jf.server_resync_kernel(kind, hyper)(x, avg, st)
    got = tf.server_resync_kernel(kind, hyper)(torch.from_numpy(x), torch.from_numpy(avg), torch.from_numpy(st))
    assert _raw(got[0]) == _raw(want[0])


@pytest.mark.parametrize("clip", [0.5, 1e-25, 1e30])
@pytest.mark.parametrize("scale", [1.0, 1e-20, 1e-30])
def test_dp_clip_flushes_as_the_reference(scale, clip):
    """``fl/dp.py:52`` ``clip_by_global_norm``: squares that underflow (a
    norm of 0 in the reference), scaled leaves that underflow, subnormal
    leaves; a matrix, a vector and a one-element leaf."""
    import jax.numpy as jnp

    from rayfed_tpu.fl import dp as jdp

    tree = {"a": _edge_values(300, 14, scale).reshape(30, 10), "b": _edge_values(77, 15, scale),
            "c": np.asarray([3e-39], np.float32)}
    want, want_norm = jdp.clip_by_global_norm({k: jnp.asarray(v) for k, v in tree.items()}, clip)
    got, got_norm = tdp.clip_by_global_norm({k: torch.from_numpy(v) for k, v in tree.items()}, clip)
    assert _raw(got_norm) == _raw(want_norm)
    for k in tree:
        assert _raw(got[k]) == _raw(want[k]), k


@pytest.mark.parametrize("n", [2, 3, 5, 7])
def test_tree_average_flushes_as_the_reference(n):
    """``fl/fedavg.py:57`` ``_tree_mean``: the adds in order, then the
    product with f32(1/n) (XLA's rewrite of the division by the count), on
    leaves with subnormals and sums that land near 2^-126; f32 and bf16
    leaves."""
    from rayfed_tpu.fl import fedavg as jf

    trees = [{"w": _edge_values(N, 40 + i, 1e-37 if i % 2 else 1.0), "b": _edge_values(33, 50 + i)}
             for i in range(n)]
    want = jf.tree_average(trees)
    got = tf.tree_average([{k: torch.from_numpy(v) for k, v in t.items()} for t in trees])
    for k in want:
        assert _raw(got[k]) == _raw(want[k]), k
    want = jf.tree_average([{"w": _jwire(t["w"], torch.bfloat16)} for t in trees])
    got = tf.tree_average([{"w": torch.from_numpy(t["w"]).to(torch.bfloat16)} for t in trees])
    assert _raw(got["w"]) == _raw(want["w"])


@pytest.mark.parametrize("n", [3, 4, 5])
def test_robust_reducers_flush_as_the_reference(n):
    """``fl/robust.py:60`` ``_median_tree``, ``:87`` ``_tmean_tree`` (trim 0
    and 1) byte for byte; ``:135`` ``_krum_scores_flat`` on updates whose
    products all underflow: every score is 0 in the reference, and so in the
    port."""
    from rayfed_tpu.fl import robust as jrb

    st = np.stack([_edge_values(1001, 20 + i) for i in range(n)])
    assert _raw(trb._median_tree({"w": torch.from_numpy(st)})["w"]) == _raw(jrb._median_tree({"w": st})["w"])
    for trim in (0, 1):
        want = jrb._tmean_tree({"w": st}, trim)["w"]
        assert _raw(trb._tmean_tree({"w": torch.from_numpy(st)}, trim)["w"]) == _raw(want), trim
    flat = np.stack([_edge_values(1001, 30 + i, 1e-20) for i in range(n + 2)])
    want = np.asarray(jrb._krum_scores_flat(flat, n - 1))
    assert not want.any()
    assert _raw(trb._krum_scores_flat(torch.from_numpy(flat), n - 1)) == want.tobytes()
