"""The CUDA flash-attention kernels vs their plain versions, on the card.

Needs an NVIDIA card and nvcc; skipped elsewhere.  This file imports no JAX,
so it runs where only the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_flash_kernel.py

Forward tolerances: f32 inputs differ from the plain version only in
summation order (1e-4).  bf16 outputs are one bf16 rounding apart at most
(|o| < 5: 4e-2); lse is f32 from exact bf16 products (1e-3).

Backward tolerances, as a share of the plain gradient's max |g| plus a
share of |g|: f32 in and out, summation order only (1e-4 + 1e-4·|g|).
bf16: both versions round dS and P to bf16 before the second products, and
the kernel's f32 scores differ from the plain version's in the last bits,
so a few dS values round the other way; the gradients are then rounded to
bf16 (2⁻⁶·|g|) and sums over up to 1000 keys add the flipped roundings
(1e-2·max|g|).  Where no key is visible to a query, or no query to a key,
the gradient must be exactly 0.

bf16 inputs run the tensor-core kernels (the forward, dQ and dK/dV), which
sum in their own order, so no bf16 result is bit-identical to the plain
version; the known-answer probe holds their
building blocks (TMA loads, both wgmma forms) against torch's f32 matmul
(f32 sums of exact bf16 products in another order: 1e-3) and an exact copy.
"""

import pytest
import torch

from rayfed_tpu_torch.ops.attention import dot_product_attention
from rayfed_tpu_torch.ops.flash_attention import (
    NEG_INF,
    _flash_backward,
    _flash_backward_reference,
    _flash_forward,
    _flash_forward_reference,
    _hopper_probe,
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
    # The edges of the tensor-core kernels' 128-row tiles (and dK/dV's
    # 64-row q tiles): one short, exact, one over, two tiles and one over.
    "bf16_t127": (4, 127, 127, 128, torch.bfloat16, None, True, 0, 0, None),
    "bf16_t128": (4, 128, 128, 64, torch.bfloat16, None, True, 0, 0, None),
    "bf16_t129": (4, 129, 129, 128, torch.bfloat16, None, True, 0, 0, None),
    "bf16_t257": (4, 257, 257, 64, torch.bfloat16, None, True, 0, 0, None),
    # Offsets that are not multiples of a tile; then q before k, so the
    # second q tile holds fully masked rows beside live ones.
    "bf16_offsets_200_72": (4, 300, 400, 128, torch.bfloat16, None, True, 200, 72, None),
    "bf16_offsets_72_250": (4, 300, 400, 64, torch.bfloat16, None, True, 72, 250, None),
    "bf16_window1": (4, 200, 200, 128, torch.bfloat16, None, True, 0, 0, 1),
    # Tk shorter than one k/v tile.
    "bf16_short_k_d64": (4, 100, 50, 64, torch.bfloat16, None, False, 0, 0, None),
    "bf16_short_k_d128": (4, 70, 30, 128, torch.bfloat16, None, True, 40, 0, None),
    "bf16_f32out_ragged": (4, 257, 257, 64, torch.bfloat16, torch.float32, True, 0, 0, 100),
    # The edges of dQ's 64-key tiles: one key short, exact, one over.
    "bf16_tk63_d64": (4, 200, 63, 64, torch.bfloat16, None, True, 0, 0, None),
    "bf16_tk63_d128": (4, 200, 63, 128, torch.bfloat16, None, False, 0, 0, None),
    "bf16_tk64_d64": (4, 200, 64, 64, torch.bfloat16, None, False, 0, 0, None),
    "bf16_tk64_d128": (4, 200, 64, 128, torch.bfloat16, None, True, 0, 0, None),
    "bf16_tk65_d64": (4, 200, 65, 64, torch.bfloat16, None, True, 0, 0, None),
    "bf16_tk65_d128": (4, 200, 65, 128, torch.bfloat16, None, False, 0, 0, None),
    # A kv offset inside a key tile and a window edge that moves mid-tile.
    "bf16_kv_offset37_window90": (4, 300, 400, 128, torch.bfloat16, None, True, 200, 37, 90),
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


@pytest.mark.parametrize("d,n", [(64, 64), (64, 128), (128, 64), (128, 128)])
def test_hopper_probe_known_answers(cuda, d, n):
    """TMA loads (ragged box, second head), the SS and RS wgmma products and
    their shared-memory descriptors, at the kernels' operand shapes."""
    g = torch.Generator(device=cuda).manual_seed(d + n)
    a = torch.randn(2, 50, d, generator=g, device=cuda).to(torch.bfloat16)
    b = torch.randn(1, n, d, generator=g, device=cuda).to(torch.bfloat16)
    v = torch.randn(1, n, d, generator=g, device=cuda).to(torch.bfloat16)
    p = torch.rand(64, n, generator=g, device=cuda).to(torch.bfloat16)
    s, o, a_tile = _hopper_probe(a, b, v, p)
    torch.cuda.synchronize()
    a_pad = torch.zeros(64, d, dtype=torch.bfloat16, device=cuda)
    a_pad[:50] = a[1]
    assert torch.equal(a_tile, a_pad)
    # f32 sums of exact bf16 products, in another order than torch's.
    torch.testing.assert_close(s, a_pad.float() @ b[0].float().T, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(o, p.float() @ v[0].float(), atol=1e-3, rtol=1e-4)


def test_unaligned_bf16_input_raises(cuda):
    q = torch.zeros(1, 8 * 128 + 1, dtype=torch.bfloat16, device=cuda)[:, 1:].view(1, 8, 128)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        _flash_forward(q, q, q, scale=1.0, causal=True)


def test_unsupported_head_dim_raises(cuda):
    q = torch.zeros(1, 8, 96, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        _flash_forward(q, q, q, scale=1.0, causal=True)


BWD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 2.0**-6)}


def _seen_keys(t_q, t_k, causal, q_off, kv_off, window, device):
    """Which keys some query sees (the others must get dK = dV = 0)."""
    if not causal:
        return torch.ones(t_k, dtype=torch.bool, device=device)
    q_pos = q_off + torch.arange(t_q, device=device)[:, None]
    k_pos = kv_off + torch.arange(t_k, device=device)[None, :]
    vis = q_pos >= k_pos
    if window is not None:
        vis = vis & (q_pos - k_pos < window)
    return vis.any(dim=0)


@pytest.mark.parametrize("case", list(CASES))
def test_backward_kernels_match_plain_version(cuda, case):
    bh, t_q, t_k, d, dtype, out_dtype, causal, q_off, kv_off, window = CASES[case]
    g = torch.Generator(device=cuda).manual_seed(len(case) + 100)
    q = torch.randn(bh, t_q, d, generator=g, device=cuda).to(dtype)
    k = torch.randn(bh, t_k, d, generator=g, device=cuda).to(dtype)
    v = torch.randn(bh, t_k, d, generator=g, device=cuda).to(dtype)
    do = torch.randn(bh, t_q, d, generator=g, device=cuda).to(dtype)
    kw = dict(scale=d**-0.5, causal=causal, q_offset=q_off, kv_offset=kv_off, window=window)
    o, lse = _flash_forward(q, k, v, **kw)
    before = (flash_attention.bwd_dq_launches, flash_attention.bwd_dkv_launches)
    grads = _flash_backward(q, k, v, o, lse, do, out_dtype=out_dtype, **kw)
    torch.cuda.synchronize()
    assert (flash_attention.bwd_dq_launches, flash_attention.bwd_dkv_launches) == (
        before[0] + 1, before[1] + 1)
    refs = _flash_backward_reference(q, k, v, o, lse, do, out_dtype=out_dtype, **kw)
    atol_frac, rtol = BWD_TOL[dtype]
    for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        if window == 1 and name in ("dq", "dk"):
            # Each query sees one key: P = 1 there, dP = δ, so dS = 0 and
            # dQ = dK = 0 up to rounding noise, which no tolerance relative
            # to that noise can hold.  Held to 1e-4 of max|dV| instead.
            bound = 1e-4 * refs[2].float().abs().max()
            assert got.float().abs().max() <= bound and ref.float().abs().max() <= bound, name
            continue
        ref32 = ref.float()
        err = (got.float() - ref32).abs()
        limit = atol_frac * ref32.abs().max() + rtol * ref32.abs()
        assert bool(torch.all(err <= limit)), f"{name}: max err {err.max().item():.3e}"
    dq, dk, dv = grads
    assert torch.all(dq[lse <= NEG_INF / 2] == 0)
    unseen = ~_seen_keys(t_q, t_k, causal, q_off, kv_off, window, cuda)
    assert torch.all(dk[:, unseen] == 0) and torch.all(dv[:, unseen] == 0)


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=True, window=40),
                                dict(causal=False)], ids=["causal", "window", "dense"])
def test_autograd_through_the_kernels_matches_dense(cuda, kw):
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v, w = (torch.randn(2, 130, 4, 64, generator=g, device=cuda) for _ in range(4))
    grads = []
    for fn in (flash_attention, dot_product_attention):
        qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
        before = flash_attention.bwd_dq_launches
        (fn(*qkv, **kw) * w).sum().backward()
        assert flash_attention.bwd_dq_launches == before + (fn is flash_attention)
        grads.append([x.grad for x in qkv])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-4 * b.abs().max().item(), rtol=1e-4)
