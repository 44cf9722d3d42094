"""The flash ring and the zigzag ring on the card against one-card flash.

Needs an NVIDIA card and nvcc; skipped elsewhere.  This file imports no JAX,
and the ranks run only the package's code
(``rayfed_tpu_torch.tools.parallel_check``):

    python -m pytest --noconftest -m gpu tests/test_torch_parallel_gpu.py

Two ranks share the card in one gloo world (the K/V rotations staged
through pinned host buffers); every ring step launches the Hopper flash
kernels.  bf16 tolerance: the reference's 3e-2 (``test_ops_attention.py``),
and each output row within 1e-2 of its own norm (``chip_smoke.py``
``PAR_ROW_TOL``: both outputs round to bf16, a few 1e-3 of a row); the
gradients against 3e-2 of their max |g| plus 3e-2 of |g| (the ring sums its
per-step partials in f32, one-card flash inside one kernel; the form of
``chip_smoke.py``'s ``_grad_gap``).
"""

import numpy as np
import pytest
import torch

from rayfed_tpu_torch.ops.flash_attention import flash_attention
from rayfed_tpu_torch.parallel.launch import run_world
from rayfed_tpu_torch.tools.parallel_check import attention_cases

pytestmark = pytest.mark.gpu

RANKS, TOL, ROW_TOL = 2, 3e-2, 1e-2
SHAPE = (1, 512, 4, 128)  # [B, T, H, D]: 256 tokens a rank, 128 a zigzag half
CASES = {
    "ring_causal": {"causal": True, "use_flash": True},
    "ring_full": {"causal": False, "use_flash": True},
    "zigzag": {"causal": True, "use_flash": True, "layout": "zigzag"},
}
# Launches per rank r of n (PERF.md): the contiguous causal ring launches each
# kernel 1 + r times (hidden blocks are not launched), the non-causal ring n
# times, the zigzag ring 2n + 1 times.
WANT = {"ring_causal": lambda r: 1 + r, "ring_full": lambda r: RANKS, "zigzag": lambda r: 2 * RANKS + 1}


@pytest.fixture(scope="module")
def results():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from rayfed_tpu_torch.ops._build import flash_bwd_lib, flash_fwd_lib

    flash_fwd_lib(), flash_bwd_lib()  # build once, before the ranks load them
    rng = np.random.default_rng(0)
    qkv = [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(3)]
    cases = [{"op": "ring", "mesh": {"sp": RANKS}, "kw": kw, "qkv": qkv, "dtype": "bfloat16", "grad": True}
             for kw in CASES.values()]
    per_rank = run_world(attention_cases, RANKS, (cases,), timeout_s=300)
    return qkv, {n: [rank[i] for rank in per_rank] for i, n in enumerate(CASES)}, per_rank[0][-1]


def _one_card(qkv, causal):
    dev = torch.device("cuda")
    q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16).requires_grad_(True) for a in qkv)
    out = flash_attention(q, k, v, causal=causal)
    grads = torch.autograd.grad((out.float() ** 2).sum(), (q, k, v))
    return out.detach().float().cpu().numpy(), [g.float().cpu().numpy() for g in grads]


def test_world_is_gloo_with_staged_rotations(results):
    _, _, tail = results
    assert tail["backend"] == "gloo" and tail["staged_bytes"] > 0


@pytest.mark.parametrize("name", list(CASES))
def test_ring_on_the_card_matches_one_card_flash(results, name):
    qkv, res, _ = results
    out, grads = _one_card(qkv, CASES[name]["causal"])
    for rank, r in enumerate(res[name]):
        assert r["dtype"] == "bfloat16"
        np.testing.assert_allclose(r["out"], out, atol=TOL, rtol=TOL, err_msg=f"rank {rank}")
        row_err = np.linalg.norm(r["out"] - out, axis=-1) / np.linalg.norm(out, axis=-1)
        print(f"{name} rank {rank}: worst output row at {row_err.max():.3e} of its norm; gradients at "
              + ", ".join(f"{np.max(np.abs(g - ref) / (TOL * np.abs(ref).max() + TOL * np.abs(ref))):.3f}"
                          for g, ref in zip(r["grads"], grads)) + " of the bound")
        assert row_err.max() <= ROW_TOL, (rank, row_err.max())
        for i, (g, ref) in enumerate(zip(r["grads"], grads)):
            np.testing.assert_allclose(g, ref, atol=TOL * np.abs(ref).max(), rtol=TOL,
                                       err_msg=f"rank {rank} grad {i}")


@pytest.mark.parametrize("name", list(CASES))
def test_every_ring_step_launches_the_kernels(results, name):
    _, res, _ = results
    for rank, r in enumerate(res[name]):
        want = WANT[name](rank)
        assert r["launches"] == {"fwd": want, "bwd_dq": want, "bwd_dkv": want}, (rank, r["launches"])
