"""The flash kernels at the split path's shape, on the card: bert_base's
attention, [B·H = 32·12, T = 512, D = 64] bf16, non-causal, against the plain
versions; and the BERT split step's encoder gradients through the kernels
against dense attention.

Needs an NVIDIA card and nvcc; skipped elsewhere.  This file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_bert_gpu.py

Tolerances as in tests/test_torch_flash_kernel.py: bf16 o within 4e-2
(one bf16 rounding of |o| < 5), lse within 1e-3 (f32 from exact bf16
products); gradients within 1e-2·max|g| + 2⁻⁶·|g| (a few dS values round the
other way in bf16).  Encoder gradients through the kernels within 5% of
max|g| of the dense path's, chip_smoke.py's bound (the two round attention
and its gradients differently in bf16).
"""

import dataclasses

import pytest
import torch

from rayfed_tpu_torch.models import bert
from rayfed_tpu_torch.models.logistic import softmax_cross_entropy, value_and_grad
from rayfed_tpu_torch.ops.attention import dot_product_attention
from rayfed_tpu_torch.ops.flash_attention import (
    _flash_backward,
    _flash_backward_reference,
    _flash_forward,
    _flash_forward_reference,
    flash_attention,
)

pytestmark = pytest.mark.gpu

BH, T, D = 32 * 12, 512, 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(cuda, seed, n=4):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(BH, T, D, generator=g, device=cuda).to(torch.bfloat16) for _ in range(n)]


def test_forward_at_the_bert_shape_matches_plain(cuda):
    q, k, v = _inputs(cuda, 1, 3)
    kw = dict(scale=D**-0.5, causal=False)
    before = flash_attention.fwd_launches
    o, lse = _flash_forward(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.fwd_launches == before + 1
    o_ref, lse_ref = _flash_forward_reference(q, k, v, **kw)
    assert o.dtype == torch.bfloat16 and o.shape == o_ref.shape
    torch.testing.assert_close(o.float(), o_ref.float(), atol=4e-2, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=1e-6)


def test_backward_at_the_bert_shape_matches_plain(cuda):
    q, k, v, do = _inputs(cuda, 2)
    kw = dict(scale=D**-0.5, causal=False)
    o, lse = _flash_forward(q, k, v, **kw)
    before = (flash_attention.bwd_dq_launches, flash_attention.bwd_dkv_launches)
    grads = _flash_backward(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert (flash_attention.bwd_dq_launches, flash_attention.bwd_dkv_launches) == (before[0] + 1, before[1] + 1)
    refs = _flash_backward_reference(q, k, v, o, lse, do, **kw)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        ref32 = ref.float()
        err = (got.float() - ref32).abs()
        limit = 1e-2 * ref32.abs().max() + 2.0**-6 * ref32.abs()
        assert got.dtype == ref.dtype and bool(torch.all(err <= limit)), f"{name}: max err {err.max().item():.3e}"


def test_split_encoder_gradients_through_the_kernels_match_dense(cuda):
    """bert_base at depth 1, 4 sequences of 512: the encoder's gradients as
    the split step's backward computes them, flash vs dense."""
    cfg = dataclasses.replace(bert.bert_base(dtype=torch.bfloat16), num_layers=1)
    g = torch.Generator(device=cuda).manual_seed(3)
    enc, head = bert.split_params(bert.init_bert(cfg, g, device=cuda))
    ids = torch.randint(0, cfg.vocab_size, (4, T), generator=g, device=cuda)
    out = {}
    for name, fn in (("flash", flash_attention), ("dense", dot_product_attention)):
        def loss_fn(p, fn=fn):
            pooled = bert.apply_pooler(p, bert.apply_encoder(p, ids, cfg, attn_fn=fn))
            return softmax_cross_entropy(bert.apply_head(head, pooled), ids[:, 0] % 2)

        before = flash_attention.fwd_launches
        out[name] = value_and_grad(loss_fn, enc)
        assert flash_attention.fwd_launches - before == (1 if name == "flash" else 0)
    flash, dense = (out[k][1] for k in ("flash", "dense"))
    attn = {k: out[k][1]["layer0"]["attn"] for k in out}
    # The key bias's gradient is zero but for rounding (softmax cancels a
    # shift of every key by one vector): held against the query bias's.
    assert max(g["bk"].abs().max() for g in attn.values()) <= 0.05 * attn["dense"]["bq"].abs().max()
    for layer in ("embeddings", "layer0", "pooler"):
        for path in dense[layer]:
            a, b = flash[layer][path], dense[layer][path]
            for sub in (a.keys() if isinstance(a, dict) else [None]):
                if (path, sub) == ("attn", "bk"):
                    continue
                ga, gb = (a, b) if sub is None else (a[sub], b[sub])
                span = gb.abs().max()
                assert span > 0 and (ga - gb).abs().max() <= 0.05 * span, (layer, path, sub)
