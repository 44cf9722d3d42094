"""The streaming fold on the card.

Needs an NVIDIA card; skipped elsewhere.  This file imports no JAX, so on
the machine with the card it runs without the repo's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_fold_gpu.py

Tolerance: byte identity.  The fold on CUDA (the product and the add as
two kernels each block, then one divide and cast) must give the CPU fold's
bytes, streamed and one-shot; and its stream must wait for the work that
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
