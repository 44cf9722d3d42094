"""1F1B on the card: two pipeline stages of Llama decoder layers with the
flash kernels, against the same step on one card.

Needs an NVIDIA card and nvcc; skipped elsewhere.  This file imports no JAX,
and the ranks run only the package's code
(``rayfed_tpu_torch.tools.parallel_check``):

    python -m pytest --noconftest -m gpu tests/test_torch_pipeline_gpu.py

Two ranks share the card in one gloo world (the hops staged through pinned
host buffers).  The stage is 2 of 4 bf16 decoder layers at head dim 128
(each layer one launch of the flash forward; the backward recomputes it and
launches dQ and dK/dV).  The one-card step is autograd of the same loss, the
mean over microbatches of the MSE, through the 4 layers.  bf16 tolerance:
the loss within 1e-3 relative, each stacked gradient within 5% of its
max|g| (``chip_smoke.py``'s ``GRAD_REL_TOL``: the pipeline sums its
microbatches' bf16 gradients one by one, autograd inside each product).
"""

import numpy as np
import pytest
import torch

from rayfed_tpu_torch.parallel.launch import run_world
from rayfed_tpu_torch.tools.parallel_check import llama_stage_fn, mse, pipeline_cases

pytestmark = pytest.mark.gpu

RANKS, M, B, T = 2, 2, 4, 256
LLAMA = dict(num_layers=4, hidden_size=512, num_heads=4, num_kv_heads=2, intermediate_size=1024,
             max_seq_len=T)
LOSS_TOL, GRAD_TOL = 1e-3, 5e-2


def _inputs():
    from rayfed_tpu_torch.models import llama

    cfg = llama.llama_tiny(**LLAMA)
    params = llama.init_llama(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, T, cfg.hidden_size)).astype(np.float32)
    tgt = rng.standard_normal((B, T, cfg.hidden_size)).astype(np.float32)
    layers = {k: v.numpy() for k, v in params["layers"].items()}
    return dict(kind="train", stages=RANKS, mb=M, llama=LLAMA, dtype="bfloat16", params=layers, x=x, tgt=tgt)


@pytest.fixture(scope="module")
def results():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from rayfed_tpu_torch.ops._build import flash_bwd_lib, flash_fwd_lib

    flash_fwd_lib(), flash_bwd_lib()  # build once, before the ranks load them
    case = _inputs()
    return case, run_world(pipeline_cases, RANKS, ({"llama_1f1b": case},), timeout_s=300)


def _one_card(case):
    from rayfed_tpu_torch.models import llama
    from rayfed_tpu_torch.ops.flash_attention import flash_attention

    dev = torch.device("cuda")
    cfg = llama.llama_tiny(**LLAMA, dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    stage = llama_stage_fn(cfg, flash_attention, T, dev, jitted=True)
    params = {k: torch.from_numpy(v).to(dev, torch.bfloat16).requires_grad_(True) for k, v in case["params"].items()}
    x, tgt = (torch.from_numpy(case[k]).to(dev, torch.bfloat16) for k in ("x", "tgt"))
    mb = B // M
    loss = torch.stack([mse(stage(params, x[i * mb:(i + 1) * mb]), tgt[i * mb:(i + 1) * mb]) for i in range(M)]).mean()
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), {k: g.float().cpu().numpy() for k, g in zip(params, grads)}


def test_1f1b_on_the_card_matches_one_card_step(results):
    case, per_rank = results
    loss, grads = _one_card(case)
    for rank, res in enumerate(per_rank):
        r = res["llama_1f1b"]
        assert abs(r["loss"] - loss) <= LOSS_TOL * abs(loss), (rank, r["loss"], loss)
        for k, ref in grads.items():
            gap = float(np.abs(r["grads"][k] - ref).max())
            span = float(np.abs(ref).max())
            print(f"rank {rank} d{k}: {gap:.3e} of max|g| {span:.3e}")
            assert span > 0 and gap <= GRAD_TOL * span, (rank, k, gap, span)
        assert r["grads"]["wq"].tobytes() == per_rank[0]["llama_1f1b"]["grads"]["wq"].tobytes()


def test_1f1b_launches_follow_the_schedule(results):
    """Per rank, Ls = 2 layers a stage: 2·M·Ls forward launches (the forward
    and its recompute), M·Ls of dQ and of dK/dV; M live ticks and M hops."""
    _, per_rank = results
    ls = LLAMA["num_layers"] // RANKS
    for res in per_rank:
        r = res["llama_1f1b"]
        assert r["launches"] == {"fwd": 2 * M * ls, "bwd_dq": M * ls, "bwd_dkv": M * ls}, r["launches"]
        assert r["stats"]["live"] == M and r["stats"]["hops"] == M
