"""Port's Hugging Face Llama conversion (``rayfed_tpu_torch.models.hf``):
tests/test_hf_interop.py on the port, and the port's converted tree against
the reference's.

A ``transformers`` Llama with random weights (GQA, RoPE, SwiGLU, RMSNorm)
must give the port's forward the same logits after conversion (atol = rtol
= 2e-4, the reference test's tolerance), the same greedy tokens through the
KV-cache decode, and the same on tied embeddings; unimplemented features, a
state dict without a config and a missing key are refused with the
reference's exceptions.  The port's tree equals the reference's
``from_hf_llama`` tree byte for byte, and ``chip_smoke.py``'s inverse (port
params to an HF state dict) round-trips exactly.
"""

import jax
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import chip_smoke  # noqa: E402
from rayfed_tpu.models import hf as jax_hf  # noqa: E402
from rayfed_tpu_torch.models import llama  # noqa: E402
from rayfed_tpu_torch.models.hf import config_from_hf, from_hf_llama  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)


def _tiny_hf_model(tie=False, kv_heads=2):
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=kv_heads, max_position_embeddings=64,
        rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=tie,
        attn_implementation="eager",
    )
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(cfg)
    model.eval()
    return model


@pytest.mark.parametrize("kv_heads", [4, 2])  # MHA and GQA
def test_hf_llama_logit_parity(kv_heads):
    model = _tiny_hf_model(kv_heads=kv_heads)
    params, cfg = from_hf_llama(model)
    ids = torch.tensor([[3, 17, 99, 4, 55, 21, 7, 120]])
    with torch.no_grad():
        ref = model(ids).logits
    np.testing.assert_allclose(llama.apply_llama(params, ids, cfg).numpy(), ref.numpy(), **TOL)


def test_hf_llama_decode_parity():
    """The converted tree drives the KV-cache decode: greedy tokens equal
    transformers' greedy generation."""
    model = _tiny_hf_model()
    params, cfg = from_hf_llama(model)
    prompt = torch.tensor([[5, 42, 9, 77]])
    with torch.no_grad():
        hf_out = model.generate(prompt, max_new_tokens=8, do_sample=False, use_cache=True)
    assert torch.equal(llama.greedy_generate(params, cfg, prompt, 8), hf_out)


def test_hf_tied_embeddings_parity():
    model = _tiny_hf_model(tie=True)
    params, cfg = from_hf_llama(model)
    assert cfg.tie_embeddings and "lm_head" not in params
    ids = torch.tensor([[11, 2, 64, 9, 33]])
    with torch.no_grad():
        ref = model(ids).logits
    np.testing.assert_allclose(llama.apply_llama(params, ids, cfg).numpy(), ref.numpy(), **TOL)


@pytest.mark.parametrize("kw,match", [
    (dict(rope_scaling={"rope_type": "linear", "factor": 2.0}), "rope_scaling"),
    (dict(attention_bias=True), "attention_bias"),
    (dict(head_dim=8), "head_dim"),
], ids=["rope_scaling", "attention_bias", "head_dim"])
def test_hf_rejects_unimplemented_features(kw, match):
    cfg = transformers.LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                                   num_hidden_layers=1, num_attention_heads=2, **kw)
    with pytest.raises(NotImplementedError, match=match):
        jax_hf.config_from_hf(cfg)
    with pytest.raises(NotImplementedError, match=match):
        config_from_hf(cfg)


def test_hf_state_dict_requires_config():
    model = _tiny_hf_model()
    with pytest.raises(ValueError, match="config"):
        from_hf_llama(model.state_dict())
    params, cfg = from_hf_llama(model.state_dict(), config=from_hf_llama(model)[1])
    assert tuple(params["layers"]["wq"].shape) == (2, 64, 64)


def test_hf_missing_key_is_loud():
    model = _tiny_hf_model()
    state = dict(model.state_dict())
    cfg = from_hf_llama(model)[1]
    del state["model.layers.1.mlp.up_proj.weight"]
    with pytest.raises(KeyError, match="missing"):
        from_hf_llama(state, config=cfg)


@pytest.mark.parametrize("field,value", [("num_kv_heads", 4), ("vocab_size", 100)])
def test_hf_wrong_shape_is_loud(field, value):
    """A config that does not fit the checkpoint: ValueError in both."""
    model = _tiny_hf_model()
    cfg = from_hf_llama(model)[1]
    wrong = llama.LlamaConfig(**{**cfg.__dict__, field: value})
    with pytest.raises(ValueError):
        jax_hf.from_hf_llama(model.state_dict(), config=wrong)
    with pytest.raises(ValueError):
        from_hf_llama(model.state_dict(), config=wrong)


@pytest.mark.parametrize("tie", [False, True])
def test_converted_tree_equals_the_reference_byte_for_byte(tie):
    model = _tiny_hf_model(tie=tie)
    params, cfg = from_hf_llama(model)
    jparams, jcfg = jax_hf.from_hf_llama(model)
    for field in ("vocab_size", "hidden_size", "num_layers", "num_heads", "num_kv_heads",
                  "intermediate_size", "rope_theta", "rms_eps", "max_seq_len", "tie_embeddings",
                  "sliding_window"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert cfg.dtype == cfg.param_dtype == torch.float32
    jleaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(jleaves) == sum(1 for _ in _leaves(params))
    for path, want in jleaves:
        got = params
        for k in path:
            got = got[k.key]
        assert got.dtype == torch.float32 and got.is_contiguous()
        assert got.numpy().tobytes() == np.asarray(want).tobytes(), jax.tree_util.keystr(path)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def test_params_are_copies_on_the_state_dicts_device():
    """f32 copies that share no memory with the checkpoint, on the device of
    its tensors: a state dict on the meta device converts without a copy to
    the host."""
    model = _tiny_hf_model()
    params, cfg = from_hf_llama(model)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    again, _ = from_hf_llama(model)
    assert not torch.equal(again["embed"], params["embed"])
    assert not torch.equal(again["final_norm"], params["final_norm"])
    meta = {k: torch.empty(v.shape, dtype=torch.bfloat16, device="meta") for k, v in model.state_dict().items()}
    out, _ = from_hf_llama(meta, config=cfg)
    for leaf in _leaves(out):
        assert leaf.device.type == "meta" and leaf.dtype == torch.float32


@pytest.mark.parametrize("tie", [False, True])
def test_chip_smoke_inverse_round_trips_exactly(tie):
    """``chip_smoke.phase_hf``'s helper: port params → HF state dict → port
    params gives the same bytes, and the state dict is the model's own."""
    model = _tiny_hf_model(tie=tie)
    params, cfg = from_hf_llama(model)
    state = chip_smoke._to_hf_state(params, cfg)
    assert set(state) <= set(model.state_dict())
    assert {n for n in model.state_dict() if n.startswith("model.")} <= set(state)
    for name, want in state.items():
        assert torch.equal(want, model.state_dict()[name]), name
    back, _ = from_hf_llama(state, config=cfg)
    for a, b in zip(_leaves(back), _leaves(params)):
        assert torch.equal(a, b)
