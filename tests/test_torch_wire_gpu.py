"""The port's wire codec with CUDA tensors, on the card.

Needs an NVIDIA card; skipped elsewhere.  This file imports no JAX, so on
the machine with the card it runs without the repo's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_wire_gpu.py

Tolerance: byte identity.  A CUDA tensor must encode to the bytes its CPU
copy encodes to, and decode onto the card with the same bytes.
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from rayfed_tpu_torch.executor import TaskExecutor
from rayfed_tpu_torch.transport import wire
from rayfed_tpu_torch.utils.platform import fence_for_handoff

pytestmark = pytest.mark.gpu

SPIN_CYCLES = 1_000_000_000  # ~0.5 s of one SM spinning: outlasts the encode call


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _bytes(bufs):
    return b"".join(bytes(b.produce()) if isinstance(b, wire.LazyBuffer) else bytes(b) for b in bufs)


def _raw(t):
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _tensors(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    big = torch.randn(4096, 2048, generator=gen, device=cuda)  # 32 MiB
    return {
        "f32": torch.randn(33, 17, generator=gen, device=cuda),
        "bf16": torch.randn(64, 128, generator=gen, device=cuda).to(torch.bfloat16),
        "zero_d": torch.randn((), generator=gen, device=cuda),
        "noncontiguous": big[:, ::3].T,
        "big_8mib": big[:1024],
        "big_bf16": big.to(torch.bfloat16),
    }


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("name", ["f32", "bf16", "zero_d", "noncontiguous", "big_8mib", "big_bf16"])
def test_cuda_round_trip(cuda, name, lazy):
    x = _tensors(cuda)[name]
    payload = _bytes(wire.encode_payload({"x": x, "tag": name}, lazy_shards=lazy))
    assert payload == _bytes(wire.encode_payload({"x": x.cpu(), "tag": name}, lazy_shards=lazy))
    out = wire.decode_payload(payload, device_put=True, device=cuda)
    assert out["tag"] == name
    y = out["x"]
    assert y.device.type == "cuda" and y.dtype == x.dtype and y.shape == x.shape
    assert _raw(y) == _raw(x)
    host = wire.decode_payload(payload)["x"]  # without device_put: on the host
    assert host.device.type == "cpu" and _raw(host) == _raw(x)
    default = wire.decode_payload(payload, device_put=True)["x"]  # device=None: the card
    assert default.device.type == "cuda"


def _slow_fill(x, stream, value):
    """Enqueue on ``stream`` a spin and then ``x.fill_(value)``."""
    with torch.cuda.stream(stream):
        torch.cuda._sleep(SPIN_CYCLES)
        x.fill_(value)


def test_d2h_waits_for_a_kernel_on_another_stream(cuda):
    """The producer's stream is still busy when another thread encodes:
    the copy must wait for it through the hand-off fence."""
    side = torch.cuda.Stream(device=cuda)
    for lazy, shape in ((False, (256, 256)), (True, (4096, 1024))):
        x = torch.zeros(shape, device=cuda)
        torch.cuda.synchronize()
        _slow_fill(x, side, 7.0)

        def produce():
            torch.cuda.set_stream(side)  # this thread now works on `side`
            try:
                fence_for_handoff(x)
            finally:
                torch.cuda.set_stream(torch.cuda.default_stream(cuda))

        t = threading.Thread(target=produce)
        t.start()
        t.join(30)
        assert not t.is_alive()
        assert not side.query(), "the spin ended before the encode; raise SPIN_CYCLES"
        with ThreadPoolExecutor(1) as pool:
            payload = pool.submit(lambda: _bytes(wire.encode_payload(x, lazy_shards=lazy))).result(60)
        out = wire.decode_payload(payload)
        assert bool((out == 7.0).all()), f"lazy={lazy}: shipped bytes the kernel had not written"


def test_executor_task_on_a_side_stream_is_fenced(cuda):
    """A task whose work is still running on its own stream when it
    returns: the executor fences its result, the transport's copy waits."""
    side = torch.cuda.Stream(device=cuda)
    ex = TaskExecutor(max_workers=1)
    try:
        def task():
            torch.cuda.set_stream(side)
            x = torch.zeros(512, 512, device=cuda)
            torch.cuda._sleep(SPIN_CYCLES)
            x.fill_(3.0)
            return x

        x = ex.submit(task, (), {}).resolve(timeout=60)
        assert not side.query(), "the spin ended before the encode; raise SPIN_CYCLES"
        with ThreadPoolExecutor(1) as pool:
            payload = pool.submit(lambda: _bytes(wire.encode_payload({"x": x}))).result(60)
        assert bool((wire.decode_payload(payload)["x"] == 3.0).all())
    finally:
        ex.submit(lambda: torch.cuda.set_stream(torch.cuda.default_stream(cuda)), (), {}).resolve(30)
        ex.shutdown()
