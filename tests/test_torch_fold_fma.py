"""The exact fused multiply-add of ``rayfed_tpu_torch.ops.fold`` on the CPU.

``fma_ftz`` is the plain version of the fold kernel (``csrc/fold_fma.cu``):
one rounding of ``a·b + c``, subnormal operands read as zeros.  Held against
the exact product and sum of the flushed operands, rounded once to f32
(tolerance: byte identity), against a two-op chain (which it must differ
from somewhere), and
for the dispatch rule: CPU tensors run the plain version, other devices
launch the kernel or raise, with no fallback.
"""

import time

import numpy as np
import pytest
import torch

from rayfed_tpu_torch.fl import compression as tc
from rayfed_tpu_torch.fl import quantize as qz
from rayfed_tpu_torch.fl import streaming as tss
from rayfed_tpu_torch.ops import fold, ftz
from rayfed_tpu_torch.transport import wire

CPU = torch.device("cpu")


def _raw(t):
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


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
    got = fold.fma_ftz(torch.tensor(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    want = _exact_fma(a, b, ftz.flush(torch.from_numpy(c)).numpy())
    assert got.tobytes() == want.tobytes()
    assert np.any(got != (a * b + c))  # a two-op chain rounds twice


def test_fold_forms_on_the_cpu():
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(5000, generator=gen).to(torch.bfloat16)
    y = torch.randn(5000, generator=gen)
    acc = torch.randn(5000, generator=gen)
    w, v = torch.tensor(2.3), torch.tensor(0.9)
    want = fold.fma_ftz(w, x.float(), acc)
    got = acc.clone()
    assert fold.fold_fma_(got, w, x) is got and torch.equal(got, want)
    assert torch.equal(fold.fold_fma_pair(w, x, v, y), fold.fma_ftz(w, x.float(), ftz.mul(v, y)))


def test_fold_fma_refuses_a_device_without_the_kernel():
    """Not a CPU tensor: the kernel runs or the call raises (here no card)."""
    meta = torch.empty(8, device="meta")
    w = torch.empty((), device="meta")
    with pytest.raises(RuntimeError, match="cuda"):
        fold.fold_fma_(meta, w, meta)
    with pytest.raises(RuntimeError, match="cuda"):
        fold.fold_fma_pair(w, meta, w, meta)


# -- the kernel's forms: their plain versions against the op sequence and the
# JAX package (byte identity), the run fold, the weights, the checks --------

CHAIN_WEIGHTS = {"ones": None, "ints": [3, 5, 7, 11, 13], "fractions": [1.7, 2.3, 0.9, 4.1, 0.3]}


def _wire_operands(k, n, wire, seed):
    """k operands of standard normals with signed zeros, small integers and
    subnormal values mixed in."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        x = rng.standard_normal(n).astype(np.float32)
        x[:8] = [0.0, -0.0, 1e-40, -3e-39, 1.0, -2.0, 0.25, 3.0]
        out.append(torch.from_numpy(x).to(wire))
    return out


@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32], ids=["bf16-out", "f32-out"])
@pytest.mark.parametrize("weights", sorted(CHAIN_WEIGHTS))
@pytest.mark.parametrize("wire", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_chain_plain_is_the_op_sequence_and_the_reference_program(k, wire, weights, out):
    """The chain's plain version (what a CPU tensor takes) equals the pair,
    step and finalize sequence op by op, and the JAX package's one-shot
    program ``_packed_reduce_jit``, subnormals included: both flush them as
    XLA:CPU does (``ops/ftz.py``)."""
    import jax.numpy as jnp

    from rayfed_tpu.fl import fedavg as jf
    from rayfed_tpu_torch.fl import fedavg as tf

    xs = _wire_operands(k, 3001, wire, seed=k)
    ws = [1.0] * k if CHAIN_WEIGHTS[weights] is None else [float(w) for w in CHAIN_WEIGHTS[weights][:k]]
    total = float(sum(ws))
    got = fold.fold_chain(xs, ws, total, out)

    if k == 1:
        t = ftz.mul(tf.f32_scalar(ws[0], CPU), xs[0].float())
    else:
        t = fold.fold_fma_pair(ws[0], xs[0], ws[1], xs[1])
    for x, w in zip(xs[2:], ws[2:]):
        fold.fold_fma_(t, w, x)
    seq = tf.finalize_packed_stripe(t, total, t.numel(), tc.dtype_name(out))
    assert got.dtype == out and _raw(got) == _raw(seq)

    jbufs = tuple(jnp.asarray(x.float().numpy()).astype(jnp.dtype(tc.dtype_name(wire))) for x in xs)
    ref = jf._packed_reduce_jit(tc.dtype_name(out))(jbufs, jnp.asarray(np.asarray(ws, np.float32)),
                                                    np.float32(total))
    assert np.asarray(ref).tobytes() == _raw(fold.fold_chain(xs, ws, total, out))


def _streamed(tp, weights, chunk_elems, order, split_runs=False, monkeypatch=None, cap=None):
    """A CPU StreamingAggregator over ``tp`` (party 0 local), payloads fed in
    pieces interleaved by ``order``; with ``split_runs`` every run of blocks
    is folded block by block; ``cap``: the most blocks one fold call takes.
    Returns the result and the lengths of the fold calls, in blocks."""
    runs = []
    monkeypatch.undo()  # the module's own fold, whatever an earlier call patched in
    if cap is not None:
        monkeypatch.setattr(tss, "_RUN_ELEMS", cap * chunk_elems)
    fold_block = tss._fold_block

    def recording(acc, off, chunk, w):
        runs.append(-(-chunk.numel() // chunk_elems))
        if not split_runs:
            return fold_block(acc, off, chunk, w)
        for lo in range(0, chunk.numel(), chunk_elems):
            fold_block(acc, off + lo, chunk[lo:lo + chunk_elems], w)

    monkeypatch.setattr(tss, "_fold_block", recording)
    agg = tss.StreamingAggregator(len(tp), weights=weights, out_dtype="float32", chunk_elems=chunk_elems,
                                  device=CPU)
    payloads = {i: bytearray(b"".join(bytes(memoryview(b).cast("B")) if not isinstance(b, (bytes, bytearray))
                                      else bytes(b) for b in wire.encode_payload(tp[i])))
                for i in range(1, len(tp))}
    pos = dict.fromkeys(payloads, 0)
    agg.add_local(0, tp[0])
    for i, step in order:
        p = payloads[i]
        pos[i] = min(len(p), pos[i] + step)
        if pos[i] == len(p):
            agg.sink(i).on_complete(p)
        else:
            agg.sink(i).on_bytes(memoryview(p), pos[i])
            time.sleep(0.002)
    return agg.result(timeout=60).buf, runs


@pytest.mark.parametrize("cap", [None, 3], ids=["whole-runs", "runs-of-3"])
@pytest.mark.parametrize("seed", [0, 1])
def test_run_fold_equals_the_block_fold_and_the_reference(monkeypatch, seed, cap):
    """A streaming aggregator that folds each run of blocks in one call (or
    in pieces of at most ``cap`` blocks, as ``_RUN_ELEMS`` cuts a long run)
    gives the bytes of one that folds block by block and of the JAX
    package's streamed fold (its ``_accum_kernel`` per block), under
    interleaved arrivals; f32 wire and fractional weights, so the streamed
    order differs from the one-shot chain's."""
    import jax.numpy as jnp

    from rayfed_tpu.fl import fedavg as jf
    from rayfed_tpu.fl import streaming as jss

    ce = 1 << 10
    rng = np.random.default_rng(seed)
    tp = [tc.pack_tree({"w": torch.from_numpy(rng.standard_normal(7 * ce + 77).astype(np.float32))},
                       torch.float32) for _ in range(4)]
    weights = [1.7, 2.3, 0.9, 4.1]
    order = [(int(i), int(step)) for i, step in zip(rng.integers(1, 4, 60), rng.integers(5000, 20000, 60))]
    order += [(i, 1 << 30) for i in (1, 2, 3)]
    runs_out, runs = _streamed(tp, weights, ce, order, monkeypatch=monkeypatch, cap=cap)
    blocks_out, _ = _streamed(tp, weights, ce, order, split_runs=True, monkeypatch=monkeypatch)
    assert runs_out.numpy().tobytes() == blocks_out.numpy().tobytes()
    assert max(runs) > 1 and sum(runs) == 4 * 8  # runs folded at once, every block once
    if cap is not None:
        assert max(runs) == cap  # the local contribution's 8 blocks: 3, 3, 2

    n = tp[0].buf.numel()
    acc = jnp.zeros(n, jnp.float32)
    for p, w in zip(tp, weights):
        x = jnp.asarray(p.buf.numpy())
        for off in range(0, n, ce):
            c = min(ce, n - off)
            acc = jss._accum_kernel(c, "float32", "float32")(acc, x[off:off + c], off, jnp.float32(w))
    ref = np.asarray(jf.finalize_packed_stripe(acc, float(sum(weights)), n, np.float32))
    assert runs_out.numpy().tobytes() == ref.tobytes()


@pytest.mark.parametrize("codes", [torch.float32, torch.uint8], ids=["f32-codes", "uint8-codes"])
@pytest.mark.parametrize("step", ["residual", "dequantize"])
def test_rows_plain_gives_the_codec_bytes(step, codes):
    """The rows form's plain version over the grid's block rows (whole
    blocks and the short last one) gives the JAX package's residual and
    dequantized bytes, from f32 codes and from the uint8 codes the card's
    dequantize reads."""
    import jax.numpy as jnp

    from rayfed_tpu.fl import quantize as jqz

    ce, n = 1 << 10, 3 * (1 << 10) + 77
    rng = np.random.default_rng(3)
    ref = rng.standard_normal(n).astype(np.float32)
    buf = ref + 0.01 * rng.standard_normal(n).astype(np.float32)
    resid = 0.001 * rng.standard_normal(n).astype(np.float32)
    grid = qz.make_round_grid(0.01 * rng.standard_normal(n).astype(np.float32), chunk_elems=ce, mode="delta",
                              expand=4.0)
    qbuf, jresid = jqz._quantize_kernel(ce, n, "uint8", True)(
        jnp.asarray(buf), jnp.asarray(ref), jnp.asarray(grid.scales), jnp.asarray(grid.zps), jnp.asarray(resid))
    q = torch.from_numpy(np.asarray(qbuf)).to(codes)
    sc, zp = torch.from_numpy(grid.scales)[:, None], torch.from_numpy(grid.zps)[:, None]
    if step == "residual":
        c = torch.from_numpy(buf) - torch.from_numpy(ref) + torch.from_numpy(resid)
        want = np.asarray(jresid)
    else:
        c = torch.from_numpy(ref)
        want = np.asarray(jqz._dequantize_kernel(ce, n, "uint8", "float32", True)(
            qbuf, jnp.asarray(ref), jnp.asarray(grid.scales), jnp.asarray(grid.zps)))
    pieces = [fold.fma_rows(sc[lo:hi], q[lo * ce:min(hi * ce, n)].reshape(hi - lo, -1),
                            c[lo * ce:min(hi * ce, n)].reshape(hi - lo, -1), zp[lo:hi],
                            negate=step == "residual")
              for lo, hi in ((0, n // ce), (n // ce, n // ce + 1))]
    assert torch.cat([p.reshape(-1) for p in pieces]).numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("value", [1 / 3, -0.0, 1e-39, 3.4e38])
def test_by_value_weights_are_f32_scalar_bits(value):
    """A weight reaches the kernel as a C float made from ``f32_arg``: the
    bits ``f32_scalar`` puts on a device, for a float and a CPU 0-d tensor."""
    import ctypes

    from rayfed_tpu_torch.fl import fedavg as tf

    want = tf.f32_scalar(value, CPU).numpy().tobytes()
    for w in (value, torch.tensor(value, dtype=torch.float64), np.float64(value)):
        assert bytes(ctypes.c_float(fold.f32_arg(w))) == want


@pytest.mark.parametrize("case", ["step", "pair", "chain", "rows", "card-weight", "chain-weights",
                                  "rows-shape", "rows-vectors", "rows-c-dtype", "finalize", "ftz"])
def test_wrappers_raise_on_what_the_kernel_does_not_take(case):
    """Without a card: a tensor that is neither on the CPU nor on a CUDA
    device, a weight that lives on a device, and shapes the kernel does not
    take raise before any launch."""
    meta = torch.empty(8, device="meta")
    calls = {
        "step": (RuntimeError, "cuda", lambda: fold.fold_fma_(meta, 1.0, meta)),
        "pair": (RuntimeError, "cuda", lambda: fold.fold_fma_pair(1.0, meta, 2.0, meta)),
        "chain": (RuntimeError, "cuda", lambda: fold.fold_chain([meta, meta], [1.0, 2.0], 3.0, torch.float32)),
        "rows": (RuntimeError, "cuda", lambda: fold.fma_rows(torch.empty(2, 1, device="meta"),
                                                             meta.reshape(2, 4), meta.reshape(2, 4))),
        "card-weight": (TypeError, "host numbers", lambda: fold.f32_arg(torch.ones((), device="meta"))),
        "chain-weights": (ValueError, "one weight per operand",
                          lambda: fold.fold_chain([meta, meta], [1.0], 1.0, torch.float32)),
        "rows-shape": (ValueError, "rows, width", lambda: fold.fma_rows(torch.empty(1, device="meta"), meta, meta)),
        "rows-vectors": (ValueError, "scale and zero point", lambda: fold.fma_rows(
            torch.empty(3, 1, device="meta"), meta.reshape(2, 4), meta.reshape(2, 4))),
        "finalize": (RuntimeError, "cuda", lambda: fold.finalize(meta, 2.0, torch.bfloat16)),
        "ftz": (RuntimeError, "cuda", lambda: fold.ftz_binary("mul", meta, meta)),
        "rows-c-dtype": (ValueError, "f32 c", lambda: fold.fma_rows(
            torch.empty(2, 1, device="meta"), meta.reshape(2, 4), meta.reshape(2, 4).to(torch.bfloat16))),
    }
    exc, match, call = calls[case]
    with pytest.raises(exc, match=match):
        call()
