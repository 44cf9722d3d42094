"""The streaming fold on the card.

Needs an NVIDIA card; skipped elsewhere.  This file imports no JAX, so on
the machine with the card it runs without the repo's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_fold_gpu.py

Tolerance: byte identity.  The fold on CUDA (one exactly rounded
multiply-add per party and block, then one divide and cast) must give the
CPU fold's bytes, streamed and one-shot, also where ``w·x`` is inexact (f32
wire buffers, fractional weights); and its stream must wait for the work that
produced a local contribution and be waited on by whoever reads the result.
The compressed-domain round on CUDA (the codec's codes, residuals and
dequantized buffers, the i32 fold and its finalize) must give the CPU's
bytes too.  Each form of the fold kernel (the step, the pair, the chain, the
finalize and the rows) must give its plain version's bytes on the same card
inputs, with the operands at any element offset: at offsets that no head
aligns (the scalar kernel) and at one common offset (the vector kernel after
a head), and at the flush of subnormals.
"""

import random
import threading
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from rayfed_tpu_torch.fl import compression as tc
from rayfed_tpu_torch.fl import fedavg as tf
from rayfed_tpu_torch.fl import quantize as qz
from rayfed_tpu_torch.fl.streaming import StreamingAggregator
from rayfed_tpu_torch.transport import wire

pytestmark = pytest.mark.gpu

SPIN_CYCLES = 1_000_000_000  # ~0.5 s of one SM spinning


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _raw(t):
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _payload(packed):
    return b"".join(
        bytes(b.produce()) if isinstance(b, wire.LazyBuffer) else bytes(b)
        for b in wire.encode_payload(packed)
    )


def _contribs(n, elems, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [
        tc.pack_tree({"a": torch.randn(elems // 3, generator=gen),
                      "b": torch.randn(elems - elems // 3, generator=gen)})
        for _ in range(n)
    ]


@pytest.mark.parametrize("weights", [None, [3, 5, 7, 11]], ids=["mean", "3-5-7-11"])
@pytest.mark.parametrize("out_dtype", [None, "float32"], ids=["bf16-out", "f32-out"])
@pytest.mark.parametrize("chunk_elems", [1 << 12, 1 << 21])
def test_cuda_fold_equals_the_cpu_fold(cuda, weights, out_dtype, chunk_elems):
    cpu = _contribs(4, 3 * (1 << 21) + 1001)
    plain = tf.packed_weighted_sum(cpu, weights, out_dtype=out_dtype)
    on_card = [tc.PackedTree(p.buf.to(cuda), p.passthrough, p.spec) for p in cpu]
    one_shot = tf.packed_weighted_sum(on_card, weights, out_dtype=out_dtype)
    assert one_shot.buf.device.type == "cuda" and _raw(one_shot.buf) == _raw(plain.buf)

    agg = StreamingAggregator(4, weights=weights, out_dtype=out_dtype, chunk_elems=chunk_elems, device=cuda)
    order = [1, 2, 3]
    random.Random(chunk_elems).shuffle(order)
    agg.add_local(0, on_card[0])
    for i in order:
        payload = bytearray(_payload(cpu[i]))
        mv, sink = memoryview(payload), agg.sink(i)
        for off in range(512 * 1024, len(payload), 512 * 1024):
            sink.on_bytes(mv, off)
        sink.on_complete(payload)
    out = agg.result(timeout=120)
    assert out.buf.device.type == "cuda" and _raw(out.buf) == _raw(plain.buf)


def _streamed(cpu, weights, device, chunk_elems=1 << 12):
    agg = StreamingAggregator(len(cpu), weights=weights, out_dtype="float32", chunk_elems=chunk_elems,
                              device=device)
    agg.add_local(0, tc.PackedTree(cpu[0].buf.to(device), cpu[0].passthrough, cpu[0].spec))
    for i in range(1, len(cpu)):
        payload = bytearray(_payload(cpu[i]))
        sink = agg.sink(i)
        sink.on_bytes(memoryview(payload), len(payload) // 2)
        sink.on_complete(payload)
    return agg.result(timeout=120).buf


@pytest.mark.parametrize("wire_dtype,weights", [(torch.float32, [3, 5, 7, 11]),
                                                (torch.bfloat16, [1.7, 2.3, 0.9, 4.1])],
                         ids=["f32-wire", "fractional-weights"])
def test_cuda_fma_fold_equals_the_cpu_fold(cuda, wire_dtype, weights):
    """Inexact products: the fused multiply-adds on the card round as the
    CPU's do, one-shot and streamed."""
    gen = torch.Generator().manual_seed(1)
    cpu = [tc.pack_tree({"w": torch.randn(3 * (1 << 12) + 77, generator=gen)}, wire_dtype) for _ in range(4)]
    plain = tf.packed_weighted_sum(cpu, weights, out_dtype="float32")
    on_card = [tc.PackedTree(p.buf.to(cuda), p.passthrough, p.spec) for p in cpu]
    one_shot = tf.packed_weighted_sum(on_card, weights, out_dtype="float32")
    assert _raw(one_shot.buf) == _raw(plain.buf)
    assert _raw(_streamed(cpu, weights, cuda)) == _raw(_streamed(cpu, weights, torch.device("cpu")))


def test_streamed_runs_staged_in_pieces_equal_the_cpu_fold(cuda, monkeypatch):
    """A run of blocks longer than ``_RUN_ELEMS`` folds piece by piece, each
    piece of payload bytes staged through one pinned block and folded in one
    launch, with the CPU fold's bytes."""
    from rayfed_tpu_torch.fl import streaming
    from rayfed_tpu_torch.ops import fold

    monkeypatch.setattr(streaming, "_RUN_ELEMS", 3 * 4096)
    gen = torch.Generator().manual_seed(4)
    cpu = [tc.pack_tree({"w": torch.randn(9 * (1 << 12) + 77, generator=gen)}) for _ in range(3)]
    before = fold.fold_fma_.by_form["step"]
    got = _streamed(cpu, [1.7, 2.3, 0.9], cuda)
    assert 3 * 4 <= fold.fold_fma_.by_form["step"] - before <= 3 * 10  # 10 blocks, at most 3 a launch
    assert _raw(got) == _raw(_streamed(cpu, [1.7, 2.3, 0.9], torch.device("cpu")))


def _edge_values(n, gen, dtype):
    """Random values with signed zeros, subnormals and exact ties mixed in."""
    x = torch.randn(n, generator=gen)
    x[: n // 8] = torch.tensor([0.0, -0.0, 1e-40, -3e-39, 1.0, -2.0, 2.0**-126, 3.0]).repeat(n // 64 + 1)[: n // 8]
    return x.to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16, torch.int32])
@pytest.mark.parametrize("n", [1, 1000, (1 << 21) + 3])
def test_fold_kernel_matches_plain_version(cuda, dtype, n):
    """``csrc/fold_fma.cu`` against ``fold.fma_ftz`` (its plain arithmetic:
    one rounding, subnormals flushed as the reference flushes them) on the
    same card inputs, the step and pair forms, byte for byte (f16 and integer
    wire elements go through f32 first, as in the reference)."""
    from rayfed_tpu_torch.ops import fold, ftz

    gen = torch.Generator().manual_seed(n)
    x, y = (_edge_values(n, gen, torch.float32).mul(100 if dtype == torch.int32 else 1).to(dtype).to(cuda)
            for _ in range(2))
    acc = _edge_values(n, gen, torch.float32).to(cuda)
    w, v = 1.7, -0.3
    wt, vt = (torch.tensor(val, dtype=torch.float32, device=cuda) for val in (w, v))
    want = fold.fma_ftz(wt, x.to(torch.float32), acc)
    before = fold.fold_fma_.launches
    got = fold.fold_fma_(acc.clone(), w, x)
    pair = fold.fold_fma_pair(w, x, v, y)
    torch.cuda.synchronize()
    assert fold.fold_fma_.launches == before + 2
    assert _raw(got) == _raw(want)
    assert _raw(pair) == _raw(fold.fma_ftz(wt, x.to(torch.float32), ftz.mul(vt, y.to(torch.float32))))


def _at(t, off):
    """``t`` as a view that starts ``off`` elements into a fresh buffer."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    view = buf[off:off + t.numel()]
    view.copy_(t)
    return view


@pytest.mark.parametrize("wire", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("n", [1, 7, 8, (1 << 21) + 3])
@pytest.mark.parametrize("off", range(8))
def test_step_and_pair_at_every_offset(cuda, wire, n, off):
    """The step and the pair at element offsets 0-7 of the accumulator and
    ``y``, with ``x`` three elements further on, so that no head aligns ``x``
    with the others and the scalar kernel runs; byte for byte against their
    plain versions on the card (the vector kernel's heads:
    ``test_vector_kernel_after_a_head``)."""
    from rayfed_tpu_torch.ops import fold

    gen = torch.Generator().manual_seed(n + off)
    x = _at(_edge_values(n, gen, torch.float32).to(wire).to(cuda), (off + 3) % 8)
    y = _at(_edge_values(n, gen, torch.float32).to(wire).to(cuda), off)
    acc = _at(_edge_values(n, gen, torch.float32).to(cuda), off)
    want = fold.step_plain(acc.clone(), 2.3, x)
    got = fold.fold_fma_(acc, 2.3, x)
    assert _raw(got) == _raw(want)
    assert _raw(fold.fold_fma_pair(-0.7, x, 1.9, y)) == _raw(fold.pair_plain(-0.7, x, 1.9, y))


CHAIN_WEIGHTS = {"ones": None, "ints": [3, 5, 7, 11, 13, 2, 9, 4, 6], "fractions": [1.7, 2.3, 0.9, 4.1, 0.3,
                                                                                   1.1, 2.9, 0.7, 3.3]}


@pytest.mark.parametrize("weights", sorted(CHAIN_WEIGHTS))
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32], ids=["bf16-out", "f32-out"])
@pytest.mark.parametrize("wire", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 9])
def test_chain_matches_plain_version(cuda, k, wire, out, weights):
    """The one-shot chain with its finalize against its plain version on the
    card, byte for byte, each operand at its own element offset; one launch
    for up to ``fold.MAX_OPS`` operands, one more per further eight."""
    from rayfed_tpu_torch.ops import fold

    gen = torch.Generator().manual_seed(k)
    n = (1 << 20) + 5
    xs = [_at(_edge_values(n, gen, torch.float32).to(wire).to(cuda), i % 8) for i in range(k)]
    ws = [1.0] * k if CHAIN_WEIGHTS[weights] is None else CHAIN_WEIGHTS[weights][:k]
    total = float(sum(ws))
    before = fold.fold_fma_.by_form["chain"]
    got = fold.fold_chain(xs, ws, total, out)
    assert fold.fold_fma_.by_form["chain"] - before == -(-k // fold.MAX_OPS)
    want = fold.chain_plain(xs, ws, total, out)
    assert got.dtype == out and _raw(got) == _raw(want)


@pytest.mark.parametrize("negate", [False, True], ids=["ref-add", "residual"])
@pytest.mark.parametrize("codes", [torch.float32, torch.uint8, torch.int8])
@pytest.mark.parametrize("shape", [(3, 1 << 21), (1, 4099), (5, 1024), (4, 1)])
def test_rows_match_plain_version(cuda, shape, codes, negate):
    """The rows form at the codec's block shapes (whole 2^21-element blocks,
    a short last block, the finalize tail's rows of one) against its plain
    version on the card, byte for byte, with and without the zero point."""
    from rayfed_tpu_torch.ops import fold

    gen = torch.Generator().manual_seed(shape[1])
    rows, width = shape
    if codes == torch.float32:
        b = torch.round(torch.randn(shape, generator=gen) * 60)
    else:
        b = torch.randint(0, 256, shape, generator=gen).to(torch.uint8).view(codes) if codes == torch.int8 \
            else torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)
    b = b.to(cuda)
    c = _edge_values(rows * width, gen, torch.float32).reshape(shape).to(cuda)
    s = (torch.rand(rows, 1, generator=gen) * 1e-2).to(cuda)
    z = torch.round(torch.randn(rows, 1, generator=gen) * 100).to(cuda)
    for zp in (z, None):
        got = fold.fma_rows(s, b, c, zp, negate=negate)
        assert _raw(got) == _raw(fold.rows_plain(s, b, c, zp, negate=negate))


@pytest.mark.parametrize("wire", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("n", [1, 7, 8, 1027, (1 << 21) + 3])
@pytest.mark.parametrize("off", range(1, 8))
def test_vector_kernel_after_a_head(cuda, wire, n, off):
    """Every operand of the step at one element offset 1-7: the vector
    kernel runs after a head of (8 − off) mod 8 bf16 or (4 − off) mod 4 f32
    elements, as the launcher's own rule (``fold.vector_head``) says; the
    pair with ``x`` and ``y`` there too, and its fresh output at 0, takes it
    where one head aligns all three.  Byte for byte against the plain
    versions on the card."""
    from rayfed_tpu_torch.ops import fold

    gen = torch.Generator().manual_seed(100 * n + off)
    x = _at(_edge_values(n, gen, torch.float32).to(wire).to(cuda), off)
    y = _at(_edge_values(n, gen, torch.float32).to(wire).to(cuda), off)
    acc = _at(_edge_values(n, gen, torch.float32).to(cuda), off)
    head = -off % (16 // x.element_size())
    assert fold.vector_head(x, acc) == head
    want = fold.step_plain(acc.clone(), 2.3, x)
    assert _raw(fold.fold_fma_(acc, 2.3, x)) == _raw(want)
    pair = fold.fold_fma_pair(-0.7, x, 1.9, y)
    assert fold.vector_head(x, y, pair) == (head if head % 4 == 0 else -1)
    assert _raw(pair) == _raw(fold.pair_plain(-0.7, x, 1.9, y))


@pytest.mark.parametrize("weights", sorted(CHAIN_WEIGHTS))
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32], ids=["bf16-out", "f32-out"])
@pytest.mark.parametrize("wire", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("k", range(1, 10))
def test_chain_vector_kernel_at_a_common_offset(cuda, k, wire, out, weights):
    """Every operand of the chain at element 4 of its buffer, the output
    fresh: the vector kernel after a head of 4 (bf16 wire, f32 out), of 0
    (f32 wire), and the scalar kernel where no head aligns a bf16 output
    with bf16 operands there; byte for byte against the plain version, for
    1 to 9 operands (9: two launches through the f32 carry)."""
    from rayfed_tpu_torch.ops import fold

    gen = torch.Generator().manual_seed(10 + k)
    n = (1 << 20) + 5
    xs = [_at(_edge_values(n, gen, torch.float32).to(wire).to(cuda), 4) for _ in range(k)]
    ws = [1.0] * k if CHAIN_WEIGHTS[weights] is None else CHAIN_WEIGHTS[weights][:k]
    total = float(sum(ws))
    got = fold.fold_chain(xs, ws, total, out)
    want_head = 0 if wire == torch.float32 else 4 if out == torch.float32 else -1
    assert fold.vector_head(*xs, got) == want_head
    assert got.dtype == out and _raw(got) == _raw(fold.chain_plain(xs, ws, total, out))


@pytest.mark.parametrize("codes", [torch.float32, torch.uint8, torch.int8])
@pytest.mark.parametrize("shape", [(3, 1 << 21), (1, 4099), (4, 1)])
def test_rows_vector_kernel_at_a_common_offset(cuda, shape, codes):
    """The rows form with ``b`` and ``c`` at element 4 of their buffers and
    the output fresh: the vector kernel after a head of 4 for 1-byte codes,
    of 0 for f32; byte for byte against the plain version, either sign, with
    and without the zero point."""
    from rayfed_tpu_torch.ops import fold

    gen = torch.Generator().manual_seed(shape[1] + 7)
    rows, width = shape
    b = torch.randint(0, 256, (rows * width,), generator=gen, dtype=torch.uint8)
    b = b.view(torch.int8) if codes == torch.int8 else b if codes == torch.uint8 else b.float() - 128
    b = _at(b.to(cuda), 4).reshape(shape)
    c = _at(_edge_values(rows * width, gen, torch.float32).to(cuda), 4).reshape(shape)
    s = (torch.rand(rows, 1, generator=gen) * 1e-2).to(cuda)
    z = torch.round(torch.randn(rows, 1, generator=gen) * 100).to(cuda)
    for negate in (False, True):
        for zp in (z, None):
            got = fold.fma_rows(s, b, c, zp, negate=negate)
            assert fold.vector_head(b, c, got) == (4 if b.element_size() == 1 else 0)
            assert _raw(got) == _raw(fold.rows_plain(s, b, c, zp, negate=negate))


def test_wrappers_raise_on_what_the_kernel_does_not_take(cuda):
    from rayfed_tpu_torch.ops import fold

    acc = torch.zeros(16, device=cuda)
    with pytest.raises(TypeError, match="host numbers"):
        fold.fold_fma_(acc, torch.ones((), device=cuda), acc)
    with pytest.raises(ValueError, match="contiguous"):
        fold.fold_fma_(torch.zeros(32, device=cuda)[::2], 1.0, acc)
    with pytest.raises(ValueError, match="one length"):
        fold.fold_fma_pair(1.0, acc, 1.0, acc[:8])
    with pytest.raises(ValueError, match="f32 c"):
        fold.fma_rows(torch.ones(2, 1, device=cuda), acc.reshape(2, 8), acc.reshape(2, 8).to(torch.bfloat16))


def test_fold_waits_for_its_inputs_and_its_readers_wait_for_it(cuda):
    """The local contribution is still being written on a side stream when
    it is handed over, and the aggregator's own stream is held back by a
    spin: the fold must read finished bytes, and a reader on another
    thread must see the finished result."""
    cpu = _contribs(2, (1 << 21) + 77, seed=1)
    plain = tf.packed_weighted_sum(cpu, [3, 5])
    side = torch.cuda.Stream(device=cuda)
    src = cpu[0].buf.to(cuda)
    torch.cuda.synchronize()
    agg = StreamingAggregator(2, weights=[3, 5], device=cuda)
    with torch.cuda.stream(agg._stream):
        torch.cuda._sleep(SPIN_CYCLES)

    def produce():
        torch.cuda.set_stream(side)
        try:
            buf = torch.zeros_like(src)
            torch.cuda._sleep(SPIN_CYCLES)
            buf.copy_(src)  # device to device, behind the spin
            agg.add_local(0, tc.PackedTree(buf, (), cpu[0].spec))
        finally:
            torch.cuda.set_stream(torch.cuda.default_stream(cuda))

    t = threading.Thread(target=produce)
    t.start()
    t.join(60)
    agg.sink(1).on_complete(_payload(cpu[1]))
    out = agg.result(timeout=120)
    assert not agg._stream.query(), "the fold ended before the read; raise SPIN_CYCLES"
    with ThreadPoolExecutor(1) as pool:
        shipped = pool.submit(lambda: _payload(out)).result(120)
    assert _raw(wire.decode_payload(shipped).buf) == _raw(plain.buf)


def _quant_round(n, elems, seed=2):
    """A reference buffer, n float updates a delta-scale away and the grid
    of a previous delta, on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    ref = torch.randn(elems, generator=gen)
    ups = [tc.pack_tree({"w": ref + 0.01 * torch.randn(elems, generator=gen)}, torch.float32)
           for _ in range(n)]
    grid = qz.make_round_grid(0.01 * torch.randn(elems, generator=gen), mode="delta", expand=4.0)
    return ref, ups, grid


def test_cuda_codec_equals_the_cpu_codec(cuda):
    ref, ups, grid = _quant_round(2, 3 * (1 << 21) + 1001)
    comps = {"cpu": qz.QuantCompressor(), "cuda": qz.QuantCompressor()}
    for up in ups:  # the second round carries the first one's residual
        got = {}
        for name, dev in (("cpu", torch.device("cpu")), ("cuda", cuda)):
            on = tc.PackedTree(up.buf.to(dev), (), up.spec)
            codes = comps[name].quantize(on, grid, ref=ref.to(dev))
            comps[name].commit()
            back = codes.dequantize(torch.float32, ref=ref.to(dev))
            got[name] = (codes.buf.tobytes(), _raw(comps[name].residual), _raw(back.buf))
            assert back.buf.device.type == dev.type and comps[name].residual.device.type == dev.type
        assert got["cuda"] == got["cpu"]


@pytest.mark.parametrize("weights", [None, [3, 5, 7, 11]], ids=["mean", "3-5-7-11"])
def test_cuda_integer_fold_equals_the_cpu_fold(cuda, weights):
    ref, ups, grid = _quant_round(4, 3 * (1 << 21) + 1001, seed=3)
    codes = [qz.quantize_packed(u, grid, ref=ref) for u in ups]
    plain = tf.packed_quantized_sum(codes, weights, ref=ref)
    on_card = [qz.QuantizedPackedTree(torch.from_numpy(c.buf).to(cuda), c.scales, c.zps, (), c.spec, c.gmeta)
               for c in codes]
    one_shot = tf.packed_quantized_sum(on_card, weights, ref=ref.to(cuda))
    assert one_shot.buf.device.type == "cuda" and _raw(one_shot.buf) == _raw(plain.buf)
    agg = StreamingAggregator(4, weights=weights, quant=grid, quant_ref=ref, device=cuda)
    agg.add_local(0, codes[0])
    for i in (2, 3, 1):
        payload = bytearray(_payload(codes[i]))
        mv, sink = memoryview(payload), agg.sink(i)
        for off in range(512 * 1024, len(payload), 512 * 1024):
            sink.on_bytes(mv, off)
        sink.on_complete(payload)
    out = agg.result(timeout=120)
    assert out.buf.device.type == "cuda" and _raw(out.buf) == _raw(plain.buf)
    # The downlink: codes and decoded bytes.
    cw, cdec, cd = qz.quantize_downlink(plain, grid, ref, None)
    gw, gdec, gd = qz.quantize_downlink(out, grid, ref.to(cuda), None)
    assert gw.buf.tobytes() == cw.buf.tobytes() and _raw(gdec.buf) == _raw(cdec.buf) and gd == cd


def _flush_edges(n, w, gen):
    """Operands whose products with ``w`` sweep 2^-126 ± 64 ulps in both
    signs, with subnormals and signed zeros every 7th element."""
    k = torch.arange(n) % 129 - 64
    base = torch.tensor(2.0 ** -126 / torch.tensor(w, dtype=torch.float32).item(), dtype=torch.float32).item()
    x = (base * (1 + k.double() * 2.0 ** -24)).float()
    x = torch.where(torch.rand(n, generator=gen) < 0.5, x, -x)
    x[::7] = torch.tensor([1e-40, -3e-39, 0.0, -0.0, 1e-45, 2.0 ** -126, -5.9e-39]).repeat(n)[: x[::7].numel()]
    return x


@pytest.mark.parametrize("w", [2.3, -0.7, 1 - 2 ** -24])
@pytest.mark.parametrize("wire_dtype", [torch.bfloat16, torch.float32])
def test_forms_flush_at_2_pow_minus_126_as_on_the_cpu(cuda, wire_dtype, w):
    """Every form at the flush: products, FMAs and quotients that land just
    below 2^-126 (tiny after rounding: a zero of its sign) or round up to
    it, and subnormal operands, give on the card the bytes of the CPU's
    plain versions, which hold the JAX package's
    (``tests/test_torch_subnormals.py``)."""
    from rayfed_tpu_torch.ops import fold

    gen = torch.Generator().manual_seed(9)
    n = 4 * 5003
    x, y, acc = (_flush_edges(n, w, gen) for _ in range(3))
    x, y = x.to(wire_dtype), y.to(wire_dtype)
    assert _raw(fold.fold_fma_(acc.clone().to(cuda), w, x.to(cuda))) == _raw(fold.step_plain(acc.clone(), w, x))
    assert _raw(fold.fold_fma_pair(w, x.to(cuda), w, y.to(cuda))) == _raw(fold.pair_plain(w, x, w, y))
    for out in (torch.bfloat16, torch.float32):
        for k in (1, 2, 3):
            xs = [x, y, x][:k]
            got = fold.fold_chain([t.to(cuda) for t in xs], [w] * k, 1.0, out)
            assert _raw(got) == _raw(fold.chain_plain(xs, [w] * k, 1.0, out)), (out, k)
        assert _raw(fold.finalize(acc.to(cuda), 1.0 / w, out)) == _raw(fold.finalize_plain(acc, 1.0 / w, out))
    rows = acc.reshape(4, -1)
    sc = torch.full((4, 1), abs(w))
    zp = torch.tensor([[0.0], [1e-40], [-0.0], [2.0 ** -126]])
    for negate in (False, True):
        got = fold.fma_rows(sc.to(cuda), rows.to(cuda), rows.to(cuda), zp.to(cuda), negate=negate)
        assert _raw(got) == _raw(fold.rows_plain(sc, rows, rows, zp, negate=negate)), negate


def _binary_operands(op, mode, gen, rows=5, width=4099):
    """``a`` [rows, width] and ``b`` (whole, one value a row, or 0-d) for the
    binary form: products and quotients that land at 2^-126 on both sides,
    sums and differences of subnormals and tiny normals."""
    ws = torch.tensor([2.3, -0.7, 1 - 2 ** -24, 1.5, 0.25])[:rows].reshape(rows, 1)
    if op in ("mul", "div"):
        per = ws if op == "mul" else 1.0 / ws
        a = torch.cat([_flush_edges(width, float(w), gen).reshape(1, width) for w in per.reshape(-1)])
        b = per
    else:
        a = _flush_edges(rows * width, 1.0, gen).reshape(rows, width)
        b = _flush_edges(rows * width, 1.0, gen).reshape(rows, width) * 0.75
    if mode == "whole":
        b = b.expand(rows, width).contiguous()
    elif mode == "scalar":
        b = b.reshape(-1)[0].clone()
    return a, b


@pytest.mark.parametrize("mode", ["whole", "per-row", "scalar"])
@pytest.mark.parametrize("op", ["add", "sub", "mul", "div"])
def test_ftz_binary_matches_plain_version(cuda, op, mode):
    """The kernel's binary form (one launch) against ``ops/ftz.py``'s PyTorch
    ops on the CPU, byte for byte, at the flush, with ``b`` read whole, one
    value a row, or one value; and with the one-value operand first."""
    from rayfed_tpu_torch.ops import fold, ftz

    gen = torch.Generator().manual_seed(11)
    a, b = _binary_operands(op, "whole" if mode == "per-row" and op in ("add", "sub") else mode, gen)
    if mode == "per-row" and op in ("add", "sub"):
        b = b[:, :1].contiguous()
    before = fold.fold_fma_.by_form["ftz"]
    got = getattr(ftz, op)(a.to(cuda), b.to(cuda))
    assert fold.fold_fma_.by_form["ftz"] == before + 1
    assert _raw(got) == _raw(getattr(ftz, op)(a, b))
    if mode == "scalar":
        got = getattr(ftz, op)(b.to(cuda), a.to(cuda))
        assert _raw(got) == _raw(getattr(ftz, op)(b, a))
