"""The ring's stripe fold and the quorum cutoff's refold on the card.

Needs an NVIDIA card; skipped elsewhere.  This file imports no JAX, so on
the machine with the card it runs without the repo's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_topology_gpu.py

Tolerance: byte identity.  A ``StripeAggregator`` on CUDA (the fold kernel
per block, the divide on the card; integer codes folded in i32 and rescaled
on the stripe's grid rows) and a quorum ``StreamingAggregator`` on CUDA whose
deadline cuts a half-folded straggler and refolds the arrived subset must
give the CPU aggregators' bytes; the quantized gather hop's codes and their
decode too.
"""

import numpy as np
import pytest
import torch

from rayfed_tpu_torch.fl import compression as tc
from rayfed_tpu_torch.fl import fedavg as tf
from rayfed_tpu_torch.fl import quantize as qz
from rayfed_tpu_torch.fl import ring
from rayfed_tpu_torch.fl.streaming import StreamingAggregator, StripeAggregator
from rayfed_tpu_torch.transport import wire

pytestmark = pytest.mark.gpu

CPU = torch.device("cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _raw(t):
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _payload(value):
    return b"".join(
        bytes(b.produce()) if isinstance(b, wire.LazyBuffer) else bytes(b)
        for b in wire.encode_payload(value)
    )


def _bufs(n, elems, dtype=torch.bfloat16, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(elems, generator=gen).to(dtype) for _ in range(n)]


@pytest.mark.parametrize("weights", [None, [1.0, 0.3, 2.7]])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_stripes_equal_the_cpu_stripes(cuda, weights, dtype):
    ce, total, n = 1 << 16, 5 * (1 << 16) + 123, 3
    bufs = _bufs(n, total, dtype)
    nb = tf.packed_block_grid(total, ce)
    for blocks in tf.packed_stripe_schedule(nb, n):
        se = ring._stripe_elems(blocks, ce, nb, total)
        outs = []
        for device in (CPU, cuda):
            agg = StripeAggregator(n, weights=weights, chunk_elems=ce, expect_elems=se, device=device)
            for i in (2, 1):
                agg.sink(i).on_complete(_payload({"data": ring._stripe_slice(bufs[i], blocks, ce, total)}))
            agg.add_local(0, ring._stripe_slice(bufs[0], blocks, ce, total).to(device))
            out = agg.result(timeout=60)
            assert out.device.type == device.type
            outs.append(_raw(out))
        assert outs[0] == outs[1]


def test_cuda_quantized_stripes_and_gather_equal_the_cpu(cuda):
    ce, total, n = 1 << 14, 4 * (1 << 14) + 77, 3
    rng = np.random.default_rng(1)
    ref = torch.from_numpy(rng.normal(size=total).astype(np.float32))
    grid = qz.make_round_grid(rng.normal(size=total).astype(np.float32), chunk_elems=ce, expand=4.0)
    codes = [torch.from_numpy(rng.integers(0, 256, size=total).astype(np.uint8)) for _ in range(n)]
    nb = tf.packed_block_grid(total, ce)
    for blocks in tf.packed_stripe_schedule(nb, n):
        se = ring._stripe_elems(blocks, ce, nb, total)
        rslice = ring._stripe_slice(ref, blocks, ce, total)
        outs, gathered = [], []
        for device in (CPU, cuda):
            agg = StripeAggregator(n, weights=[1, 2, 3], chunk_elems=ce, expect_elems=se, quant=grid,
                                   quant_blocks=blocks, quant_ref=rslice.to(device), device=device)
            for i in (1, 2):
                agg.sink(i).on_complete(_payload({"data": ring._stripe_slice(codes[i], blocks, ce, total)}))
            agg.add_local(0, ring._stripe_slice(codes[0], blocks, ce, total).to(device))
            out = agg.result(timeout=60)
            outs.append(_raw(out))
            s, z = grid.rows(blocks)
            c = ring.code_gather_stripe(out, rslice.to(device), s, z, ce, "uint8")
            gathered.append((_raw(c), _raw(ring.decode_gather_stripe(c, rslice.to(device), s, z, ce, "float32"))))
        assert outs[0] == outs[1]
        assert gathered[0] == gathered[1]


def test_cuda_quorum_refold_equals_the_cpu(cuda):
    """The deadline cuts source 1 after some of its blocks folded: the refold
    over sources 0 and 2 gives the CPU's bytes (and the one-shot fold's)."""
    ce, total = 1 << 16, 3 * (1 << 16) + 5
    gen = torch.Generator().manual_seed(4)
    packed = [tc.pack_tree({"w": torch.randn(total, generator=gen)}) for _ in range(3)]
    outs = []
    for device in (CPU, cuda):
        agg = StreamingAggregator(3, weights=[1.0, 2.0, 3.0], quorum=2, labels=["a", "b", "c"],
                                  chunk_elems=ce, device=device)
        agg.add_local(0, tc.PackedTree(packed[0].buf.to(device), (), packed[0].spec))
        payload = _payload(packed[1])
        agg.sink(1).on_bytes(memoryview(payload), len(payload) - 7)  # stalls before its last block
        agg.sink(2).on_complete(_payload(packed[2]))
        out = agg.result(timeout=60, deadline_s=1.0)
        assert agg.quorum_members == [0, 2]
        outs.append(_raw(out.buf))
    assert outs[0] == outs[1] == _raw(tf.packed_weighted_sum([packed[0], packed[2]], [1.0, 3.0]).buf)
