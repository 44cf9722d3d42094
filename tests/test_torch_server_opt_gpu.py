"""The packed server optimizers and the async buffer on the card.

Needs an NVIDIA card; skipped elsewhere.  This file imports no JAX, so on
the machine with the card it runs without the repo's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_server_opt_gpu.py

Tolerance: byte identity.  The server step and resync on CUDA tensors launch
the fold kernel (``csrc/fold_fma.cu``) for their fused multiply-adds and
their flushed subtractions and must give the CPU plain version's bytes; a ``PackedServerOptimizer`` on the
card keeps its state there; the async buffer's i32 fold on the card must
give the CPU buffer's finalized bytes.
"""

import pytest
import torch

from rayfed_tpu_torch.fl import async_rounds as ar
from rayfed_tpu_torch.fl import compression as tc
from rayfed_tpu_torch.fl import fedavg as tf
from rayfed_tpu_torch.fl import quantize as qz
from rayfed_tpu_torch.fl import server_opt as so
from rayfed_tpu_torch.ops import fold

pytestmark = pytest.mark.gpu

CONFIGS = [("momentum", (0.7, 0.9)), ("fedac", (0.8, 6.0, 0.7)), ("momentum", (1.0, 0.0)), ("fedac", (1.0, 3.0, 0.0))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _raw(t):
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("n", [7, 4099, (1 << 21) + 5])
@pytest.mark.parametrize("kind,hyper", CONFIGS, ids=lambda v: str(v))
def test_server_step_and_resync_on_the_card_equal_the_cpu(cuda, kind, hyper, n):
    gen = torch.Generator().manual_seed(n)
    x, st = torch.randn(n, generator=gen), torch.randn(n, generator=gen)
    avg = x - 0.01 * torch.randn(n, generator=gen)
    step, resync = tf.server_step_kernel(kind, hyper), tf.server_resync_kernel(kind, hyper)
    want = step(x, avg, st)
    fold.fold_fma_.launches = 0
    got = step(x.to(cuda), avg.to(cuda), st.to(cuda))
    launches = fold.fold_fma_.launches
    assert got.device.type == "cuda" and _raw(got) == _raw(want)
    degenerate = hyper in ((1.0, 0.0), (1.0, 3.0, 0.0))
    # The FMAs' launches and one of the binary form for Δ = x − avg.
    assert launches == (0 if degenerate else 3 if kind == "momentum" else 4)
    got_r = resync(x.to(cuda), got, st.to(cuda))[0]
    assert got_r.device.type == "cuda" and _raw(got_r) == _raw(resync(x, want, st)[0])


def test_optimizer_state_stays_on_the_card(cuda):
    opt = so.fedac(1.0, 3.0, 0.5)
    x = torch.randn(5000, generator=torch.Generator().manual_seed(1))
    tmpl = tc.pack_tree({"w": x}, torch.float32)
    runner, cpu_runner = so.PackedServerOptimizer(opt, device=cuda), so.PackedServerOptimizer(opt, device="cpu")
    for r in range(3):
        avg = x - 0.01 * (r + 1)
        outs = []
        for c in (runner, cpu_runner):
            c.ensure(x)
            outs.append(c.step_fn(x)(tc.PackedTree(avg, tmpl.passthrough, tmpl.spec)).buf)
            c.resync(x, outs[-1])
        assert outs[0].device.type == "cuda" and _raw(outs[0]) == _raw(outs[1])
        assert runner.state.bufs[0].device.type == "cuda"
        assert _raw(runner.state.bufs[0]) == _raw(cpu_runner.state.bufs[0])
        x = outs[1]


def test_async_buffer_on_the_card_equals_the_cpu(cuda):
    gen = torch.Generator().manual_seed(3)
    ref = torch.randn(10_000, generator=gen)
    tmpl = tc.pack_tree({"w": ref}, torch.float32)
    grid = qz.make_round_grid((0.01 * torch.randn(10_000, generator=gen)).numpy(), chunk_elems=4096, mode="delta")
    qts = [qz.quantize_packed(tc.PackedTree(ref + 0.01 * torch.randn(10_000, generator=gen), tmpl.passthrough,
                                            tmpl.spec), grid, ref=ref) for _ in range(5)]
    bufs = [ar.AsyncBuffer(grid, ref, tmpl, device=d) for d in (cuda, "cpu")]
    for i, qt in enumerate(qts):
        for b in bufs:
            b.fold(qt, 16, i % 3)
    on_card, on_cpu = (b.finalize().buf for b in bufs)
    assert bufs[0]._acc.device.type == "cuda" and on_card.device.type == "cuda"
    assert _raw(on_card) == _raw(on_cpu)
