"""The cells' inputs, made from ``--seed``: weights, adapters, token rows, images.

One generator for every cell: what it makes is set by the configuration's
sizes and the cell's traffic parameters.  Everything is drawn on the
device, one large call a leaf, in the type it is used in, so the party
processes and the plain reference get the same tensors from the same seed.
Imports nothing of the program.
"""

from __future__ import annotations

import torch

from fedbench.spec import mix

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def generator(device, seed: int, *keys) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(mix(seed, *keys))


def _normal(shape, std, dtype, device, seed, *keys):
    x = torch.randn(shape, generator=generator(device, seed, *keys), device=device, dtype=dtype)
    return x.mul_(std)


# ---------------------------------------------------------------- llama kind


def llama_dims(config: dict) -> dict:
    d, h = config["hidden_size"], config["num_attention_heads"]
    return {
        "d": d, "h": h, "kv": config["num_key_value_heads"], "dh": d // h,
        "f": config["intermediate_size"], "L": config["num_hidden_layers"], "V": config["vocab_size"],
    }


def llama_weights(config: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The frozen base in the port's layout (layers stacked on a leading
    axis, ``x @ w`` orientation), normal with the usual fan-in scales."""
    n = llama_dims(config)
    d, h, kv, dh, f, L, V = (n[k] for k in ("d", "h", "kv", "dh", "f", "L", "V"))

    def w(name, shape, std):
        return _normal(shape, std, dtype, device, seed, "llama", name)

    params = {
        "embed": w("embed", (V, d), 0.02 * d**0.5),
        "layers": {
            "attn_norm": torch.ones((L, d), dtype=dtype, device=device),
            "wq": w("wq", (L, d, h * dh), d**-0.5),
            "wk": w("wk", (L, d, kv * dh), d**-0.5),
            "wv": w("wv", (L, d, kv * dh), d**-0.5),
            "wo": w("wo", (L, h * dh, d), (h * dh) ** -0.5),
            "mlp_norm": torch.ones((L, d), dtype=dtype, device=device),
            "w_gate": w("w_gate", (L, d, f), d**-0.5),
            "w_up": w("w_up", (L, d, f), d**-0.5),
            "w_down": w("w_down", (L, f, d), f**-0.5),
        },
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
    }
    if not config.get("tie_word_embeddings", False):
        params["lm_head"] = w("lm_head", (d, V), d**-0.5)
    return params


def lora_adapters(config: dict, lora: dict, seed: int, device) -> dict:
    """The round's starting adapters: A normal times ``init_scale``, B zero,
    ``scale`` = alpha / rank; f32, stacked over the layers."""
    n = llama_dims(config)
    out_dims = {"wq": n["h"] * n["dh"], "wk": n["kv"] * n["dh"], "wv": n["kv"] * n["dh"], "wo": n["d"],
                "w_gate": n["f"], "w_up": n["f"], "w_down": n["d"]}
    in_dims = {"wo": n["h"] * n["dh"], "w_down": n["f"]}
    r, L = lora["rank"], n["L"]
    layers = {}
    for name in lora["targets"]:
        d_in, d_out = in_dims.get(name, n["d"]), out_dims[name]
        layers[name] = {
            "a": _normal((L, d_in, r), lora["init_scale"], torch.float32, device, seed, "lora", name),
            "b": torch.zeros((L, r, d_out), device=device),
            "scale": torch.tensor(lora["alpha"] / r, dtype=torch.float32, device=device),
        }
    return {"layers": layers}


def token_rows(config: dict, workload: dict, seed: int, party_index: int, device) -> torch.Tensor:
    """A party's pool of ``rows_per_party`` distinct batches, ``[R, B, T]``."""
    shape = (workload["rows_per_party"], workload["batch"], workload["seq_len"])
    g = generator(device, seed, "tokens", party_index)
    return torch.randint(0, config["vocab_size"], shape, generator=g, device=device)


# --------------------------------------------------------------- resnet kind


def resnet_blocks(config: dict):
    """``(name, stride, c_in, c_out)`` of every residual block, in order."""
    c_in = config["width"]
    for stage, count in enumerate(config["stage_sizes"]):
        c_out = config["width"] * 2**stage
        for block in range(count):
            yield f"stage{stage}_block{block}", (2 if block == 0 and stage > 0 else 1), c_in, c_out
            c_in = c_out


def resnet_weights(config: dict, seed: int, device) -> tuple:
    """``(params, state)`` in the port's tree: He-normal HWIO kernels, unit
    batch-norm scales, zero biases, a zero head; f32."""

    def conv(name, k, c_in, c_out):
        return _normal((k, k, c_in, c_out), (2.0 / (k * k * c_in)) ** 0.5, torch.float32, device, seed,
                       "resnet", name)

    def bn(c):
        return {"scale": torch.ones(c, device=device), "bias": torch.zeros(c, device=device)}

    def stats(c):
        return {"mean": torch.zeros(c, device=device), "var": torch.ones(c, device=device)}

    w, stem_k = config["width"], 3 if config["small_inputs"] else 7
    params = {"stem": {"conv": conv("stem", stem_k, config["channels"], w), "bn": bn(w)}}
    state = {"stem": stats(w)}
    c_last = w
    for name, stride, c_in, c_out in resnet_blocks(config):
        params[name] = {"conv1": conv(f"{name}.conv1", 3, c_in, c_out), "bn1": bn(c_out),
                        "conv2": conv(f"{name}.conv2", 3, c_out, c_out), "bn2": bn(c_out)}
        state[name] = {"bn1": stats(c_out), "bn2": stats(c_out)}
        if stride != 1 or c_in != c_out:
            params[name]["proj"] = conv(f"{name}.proj", 1, c_in, c_out)
            params[name]["proj_bn"] = bn(c_out)
            state[name]["proj_bn"] = stats(c_out)
        c_last = c_out
    params["head"] = {"kernel": torch.zeros((c_last, config["num_classes"]), device=device),
                      "bias": torch.zeros((config["num_classes"],), device=device)}
    return params, state


def images(config: dict, workload: dict, seed: int, party_index: int, device) -> tuple:
    """A party's shard: ``images_per_party`` NHWC images, normal, and labels
    from a fixed random linear probe of their mean colour."""
    s, c = config["image_size"], config["channels"]
    x = _normal((workload["images_per_party"], s, s, c), 1.0, torch.float32, device, seed, "images", party_index)
    probe = _normal((c, config["num_classes"]), 1.0, torch.float32, device, seed, "probe")
    # Elementwise products: no reduced-precision matmul can move a label.
    y = torch.argmax((x.mean(dim=(1, 2))[:, :, None] * probe[None]).sum(dim=1), dim=-1)
    return x, y


def image_batch(workload: dict, x: torch.Tensor, y: torch.Tensor, k: int) -> tuple:
    """Local step ``k``'s batch: the shard's ``k``-th slice, cycling."""
    b = workload["batch"]
    i = k % (x.shape[0] // b)
    return x[i * b:(i + 1) * b], y[i * b:(i + 1) * b]
