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
bytes too.
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


def _edge_values(n, gen, dtype):
    """Random values with signed zeros, subnormals and exact ties mixed in."""
    x = torch.randn(n, generator=gen)
    x[: n // 8] = torch.tensor([0.0, -0.0, 1e-40, -3e-39, 1.0, -2.0, 2.0**-126, 3.0]).repeat(n // 64 + 1)[: n // 8]
    return x.to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16, torch.int32])
@pytest.mark.parametrize("n", [1, 1000, (1 << 21) + 3])
def test_fold_kernel_matches_plain_version(cuda, dtype, n):
    """``csrc/fold_fma.cu`` against ``fold.fma`` on the same card inputs,
    both forms, byte for byte (both round once; f16 and integer wire
    elements go through f32 first, as in the reference)."""
    from rayfed_tpu_torch.ops import fold

    gen = torch.Generator().manual_seed(n)
    x, y = (_edge_values(n, gen, torch.float32).mul(100 if dtype == torch.int32 else 1).to(dtype).to(cuda)
            for _ in range(2))
    acc = _edge_values(n, gen, torch.float32).to(cuda)
    w, v = (torch.tensor(val, dtype=torch.float32, device=cuda) for val in (1.7, -0.3))
    want = fold.fma(w, x.to(torch.float32), acc)
    before = fold.fold_fma_.launches
    got = fold.fold_fma_(acc.clone(), w, x)
    pair = fold.fold_fma_pair(w, x, v, y)
    torch.cuda.synchronize()
    assert fold.fold_fma_.launches == before + 2
    assert _raw(got) == _raw(want)
    assert _raw(pair) == _raw(fold.fma(w, x.to(torch.float32), v * y.to(torch.float32)))


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
