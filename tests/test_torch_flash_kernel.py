"""The CUDA flash-attention kernel vs its plain version, on the card.

Needs an NVIDIA card and nvcc; skipped elsewhere.  This file imports no JAX,
so it runs where only the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_flash_kernel.py

Tolerances: f32 inputs differ from the plain version only in summation
order (1e-4).  bf16 outputs are one bf16 rounding apart at most (|o| < 5:
4e-2); lse is f32 from exact bf16 products (1e-3).
"""

import pytest
import torch

from rayfed_tpu_torch.ops.flash_attention import (
    NEG_INF,
    _flash_forward,
    _flash_forward_reference,
    flash_attention,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (bh, t_q, t_k, d, dtype, out_dtype, causal, q_offset, kv_offset, window)
CASES = {
    "bf16_causal": (8, 256, 256, 128, torch.bfloat16, None, True, 0, 0, None),
    "bf16_dense": (4, 200, 136, 128, torch.bfloat16, None, False, 0, 0, None),
    "bf16_window": (4, 300, 300, 128, torch.bfloat16, None, True, 0, 0, 70),
    "bf16_offsets_masked_rows": (4, 96, 160, 64, torch.bfloat16, None, True, 0, 40, None),
    "bf16_q_shard_later": (4, 64, 192, 64, torch.bfloat16, None, True, 128, 0, None),
    "ragged": (3, 1000, 1000, 128, torch.bfloat16, None, True, 0, 0, None),
    "tiny_t": (2, 1, 5, 64, torch.bfloat16, None, True, 4, 0, None),
    "f32_f32out": (4, 130, 130, 64, torch.float32, torch.float32, True, 0, 0, 33),
    "bf16_f32out": (4, 128, 128, 128, torch.bfloat16, torch.float32, True, 0, 0, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain_version(cuda, case):
    bh, t_q, t_k, d, dtype, out_dtype, causal, q_off, kv_off, window = CASES[case]
    g = torch.Generator(device=cuda).manual_seed(len(case))
    q = torch.randn(bh, t_q, d, generator=g, device=cuda).to(dtype)
    k = torch.randn(bh, t_k, d, generator=g, device=cuda).to(dtype)
    v = torch.randn(bh, t_k, d, generator=g, device=cuda).to(dtype)
    kw = dict(scale=d**-0.5, causal=causal, q_offset=q_off, kv_offset=kv_off,
              out_dtype=out_dtype, window=window)
    before = flash_attention.fwd_launches
    o, lse = _flash_forward(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.fwd_launches == before + 1
    o_ref, lse_ref = _flash_forward_reference(q, k, v, **kw)
    assert o.dtype == o_ref.dtype and o.shape == o_ref.shape
    o_tol = 1e-4 if dtype == torch.float32 else 4e-2
    lse_tol = 1e-4 if dtype == torch.float32 else 1e-3
    torch.testing.assert_close(o.float(), o_ref.float(), atol=o_tol, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=lse_tol, rtol=1e-6)
    masked = lse_ref <= NEG_INF / 2
    assert torch.equal(masked, lse <= NEG_INF / 2)
    assert torch.all(o[masked] == 0)


def test_unsupported_head_dim_raises(cuda):
    q = torch.zeros(1, 8, 96, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        _flash_forward(q, q, q, scale=1.0, causal=True)
