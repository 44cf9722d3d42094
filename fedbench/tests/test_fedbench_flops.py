"""The operation and byte counts of ``fedbench/flops`` against brute force."""

import copy

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from fedbench import spec, traffic
from fedbench.flops import fold as fold_counts
from fedbench.flops import llama as llama_counts
from fedbench.flops import resnet as resnet_counts
from fedbench.reference import fold_mean
from fedbench.reference import llama as llama_ref
from fedbench.reference import resnet as resnet_ref

TINY_LLAMA = {"hidden_size": 32, "intermediate_size": 48, "num_attention_heads": 4, "num_key_value_heads": 2,
              "num_hidden_layers": 3, "vocab_size": 40, "sliding_window": None, "torch_dtype": "float32"}


@pytest.mark.parametrize("t,window", [(1, None), (7, None), (64, 16), (64, 64), (64, 100), (33, 1), (8192, 4096)])
def test_window_pairs_brute_force(t, window):
    q = torch.arange(t)[:, None]
    k = torch.arange(t)[None, :]
    visible = k <= q
    if window is not None:
        visible &= q - k < window
    assert llama_counts.window_pairs(t, window) == int(visible.sum())


def test_window_pairs_of_the_cell():
    assert llama_counts.window_pairs(8192, 4096) == 25_167_872


@pytest.mark.parametrize("targets", [["wq", "wv"], ["wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"], ["w_up"], ["wk", "w_down"]])
def test_llama_step_flops_against_the_counted_reference(targets):
    """What autograd computes for the plain reference's LoRA step, counted by
    FlopCounterMode: one block of queries, so attention is the dense T x T."""
    _wl, config = spec.cell("mistral7b.lora_swa8k")
    config = {**config, **TINY_LLAMA}
    wl = {"batch": 2, "seq_len": 12, "rows_per_party": 1,
          "lora": {"rank": 4, "alpha": 8.0, "init_scale": 0.01, "targets": targets}}
    params = traffic.llama_weights(config, 5, "cpu", torch.float32)
    lora = traffic.lora_adapters(config, wl["lora"], 5, "cpu")
    trained = [e[w].requires_grad_(True) for e in lora["layers"].values() for w in ("a", "b")]
    ids = traffic.token_rows(config, wl, 5, 0, "cpu")[0]
    with FlopCounterMode(display=False) as counter:
        loss = llama_ref.loss_fn(params, lora, ids, config, ckpt=False)
        torch.autograd.grad(loss, trained)
    dense = wl["seq_len"] ** 2
    assert llama_counts.step_flops(config, wl, pairs=dense) == counter.get_total_flops()


def test_llama_step_flops_of_the_cell():
    wl, config = spec.cell("mistral7b.lora_swa8k")
    flops = llama_counts.step_flops(config, wl)
    assert 2.7e14 < flops < 2.75e14  # 2 x 7.11e9 x 8192 forward, as much backward, 4e13 of attention


def test_flash_call_counts():
    wl, config = spec.cell("mistral7b.lora_swa8k")
    f_fwd, b_fwd = llama_counts.flash_call(config, wl)
    f_bwd, b_bwd = llama_counts.flash_call(config, wl, backward=True)
    assert f_fwd == 4 * 32 * 25_167_872 * 128 and f_bwd == 10 * 32 * 25_167_872 * 128
    plane = 8192 * 32 * 128 * 2
    assert b_fwd == 4 * plane + 4 * 32 * 8192 and b_bwd == 8 * plane + 8 * 32 * 8192


@pytest.mark.parametrize("small", [True, False])
def test_resnet_step_flops_against_the_counted_reference(small):
    _wl, config = spec.cell("resnet18.hub4_b64")
    config = {**config, "stage_sizes": [1, 2, 1], "width": 4, "image_size": 12, "small_inputs": small}
    wl = {"batch": 3, "images_per_party": 3}
    params, _state = traffic.resnet_weights(config, 2, "cpu")
    leaves = []

    def grad_on(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                grad_on(v)
            else:
                leaves.append(v.requires_grad_(True))

    grad_on(params)
    x, y = traffic.images(config, wl, 2, 0, "cpu")
    with FlopCounterMode(display=False) as counter:
        loss = torch.nn.functional.cross_entropy(resnet_ref.forward(params, x, config), y)
        torch.autograd.grad(loss, leaves)
    assert resnet_counts.step_flops(config, wl) == counter.get_total_flops()


def test_resnet18_of_the_cell():
    wl, config = spec.cell("resnet18.hub4_b64")
    forward = (resnet_counts.step_flops(config, wl) + 2 * wl["batch"] * 3 * 32 * 32 * 9 * 64) / 3
    assert 1.10e9 * 64 < forward < 1.12e9 * 64  # ResNet-18 at 32x32: 0.556 G multiply-adds an image


@pytest.mark.parametrize("parties,elems", [(2, 7), (4, 1000)])
def test_fold_bytes_brute_force(parties, elems):
    uploads = [torch.randn(elems).to(torch.bfloat16) for _ in range(parties)]
    out = fold_mean.fold(uploads)
    touched = sum(u.numel() * u.element_size() for u in uploads) + out.numel() * out.element_size()
    assert fold_counts.round_bytes(parties, elems) == touched
    assert fold_counts.chain_bytes(parties, elems) == touched
    acc = torch.zeros(elems)
    assert fold_counts.step_bytes(elems) == 2 * acc.numel() * acc.element_size() + uploads[0].nbytes
    assert fold_counts.finalize_bytes(elems) == acc.nbytes + out.nbytes


def test_counts_read_no_program():
    cfg = copy.deepcopy(spec.cell("mistral7b.lora_swa8k")[1])
    assert llama_counts.shapes(cfg)["wk"] == (4096, 1024)
