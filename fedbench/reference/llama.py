"""Plain float32 reference of the llama kind: LoRA fine-tuning steps with Adam.

A decoder of the Mistral/Llama family as the port lays it out: RMSNorm,
q/k/v projections (each ``x @ W``, plus ``(x @ A) @ B · scale`` on the LoRA
targets), RoPE on interleaved pairs ``(x[2i], x[2i+1])`` with ``theta``,
grouped-query attention (each key/value head serves ``h / kv`` consecutive
query heads), causal with a sliding window (query ``i`` sees keys
``j`` with ``i − window < j ≤ i``), the output projection, a SwiGLU MLP,
a final RMSNorm, an untied head, and the mean next-token cross entropy.

Departures, all of layout and none of the mathematics: RoPE on
interleaved pairs is HF's ``rotate_half`` after a fixed permutation of
the q/k projection columns; the weights are random from the seed.

Float32 throughout, TF32 off.  The bfloat16 base is widened a layer at a
time (exactly); attention runs in blocks of queries against the keys
their window can see; each layer runs under a checkpoint, so the step
fits beside the base.

``follow(..., base="fp8")`` is the cell's control: the same reference with
the frozen base one precision below bfloat16, in float8 e4m3.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from fedbench import traffic
from fedbench.judge import leaf_norms, tree_leaves
from fedbench.reference import full_precision, wire_round_trip

BLOCK = 1024
FP8_MAX = 448.0
# The leaves that a low-precision base holds in 8 bits: the seven stacked
# matmul weights of the layers, and the head.
BASE_MATMULS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope_tables(t: int, dh: int, theta: float, device):
    freqs = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32, device=device) / dh)
    angles = torch.arange(t, dtype=torch.float32, device=device)[:, None] * freqs[None, :]
    return torch.cos(angles), torch.sin(angles)


def rope(x, cos, sin):
    """``x``: ``[T, H, dh]``; rotates each pair ``(x[2i], x[2i+1])``."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).reshape(x.shape)


def attention(q, k, v, window):
    """Causal attention of ``[T, H, dh]`` tensors, a block of queries at a time."""
    t, _, dh = q.shape
    out = []
    for q0 in range(0, t, BLOCK):
        q1 = min(t, q0 + BLOCK)
        k0 = 0 if window is None else max(0, q0 - window + 1)
        s = torch.einsum("qhd,khd->hqk", q[q0:q1], k[k0:q1]) * dh**-0.5
        qi = torch.arange(q0, q1, device=q.device)[:, None]
        ki = torch.arange(k0, q1, device=q.device)[None, :]
        visible = ki <= qi
        if window is not None:
            visible = visible & (qi - ki < window)
        s = s.masked_fill(~visible, float("-inf"))
        out.append(torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v[k0:q1]))
    return torch.cat(out)


def _linear(y, w, entry):
    out = y @ w.float()
    if entry is not None:
        out = out + (y @ entry["a"]) @ entry["b"] * entry["scale"]
    return out


def layer(x, params, lora, i, config, cos, sin):
    """Decoder layer ``i`` on one row ``x``: ``[T, d]``."""
    n = traffic.llama_dims(config)
    t, eps = x.shape[0], config["rms_norm_eps"]
    lw = {k: v[i] for k, v in params["layers"].items()}
    le = {k: {"a": e["a"][i], "b": e["b"][i], "scale": e["scale"]} for k, e in lora["layers"].items()}
    y = rms_norm(x, lw["attn_norm"].float(), eps)
    q = _linear(y, lw["wq"], le.get("wq")).view(t, n["h"], n["dh"])
    k = _linear(y, lw["wk"], le.get("wk")).view(t, n["kv"], n["dh"])
    v = _linear(y, lw["wv"], le.get("wv")).view(t, n["kv"], n["dh"])
    q, k = rope(q, cos, sin), rope(k, cos, sin)
    rep = n["h"] // n["kv"]
    k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    a = attention(q, k, v, config["sliding_window"]).reshape(t, n["h"] * n["dh"])
    x = x + _linear(a, lw["wo"], le.get("wo"))
    y = rms_norm(x, lw["mlp_norm"].float(), eps)
    h = F.silu(_linear(y, lw["w_gate"], le.get("w_gate"))) * _linear(y, lw["w_up"], le.get("w_up"))
    return x + _linear(h, lw["w_down"], le.get("w_down"))


def loss_fn(params, lora, ids, config, ckpt: bool = True):
    """Mean next-token cross entropy over every row of ``ids``: ``[B, T]``."""
    n = traffic.llama_dims(config)
    cos, sin = rope_tables(ids.shape[1], n["dh"], float(config["rope_theta"]), ids.device)
    head = params["embed"].T if config.get("tie_word_embeddings", False) else params["lm_head"]
    total = 0.0
    for row in ids:
        x = params["embed"][row].float()
        for i in range(n["L"]):
            if ckpt:
                x = checkpoint(layer, x, params, lora, i, config, cos, sin, use_reentrant=False)
            else:
                x = layer(x, params, lora, i, config, cos, sin)
        logits = rms_norm(x, params["final_norm"].float(), config["rms_norm_eps"]) @ head.float()
        total = total + F.cross_entropy(logits[:-1], row[1:], reduction="sum")
    return total / (ids.shape[0] * (ids.shape[1] - 1))


def fp8_round_trip_(w: torch.Tensor, batch_axes: int) -> None:
    """``w`` (``[..., d_in, d_out]``, ``x @ w``) rounded in place to float8
    e4m3 with a scale per (leading index, output channel), as an 8-bit base
    is scaled.  The scales are powers of two, so every rounded value is
    exact in ``w``'s bfloat16."""
    for idx in (range(w.shape[0]) if batch_axes else [slice(None)]):
        x = w[idx].float()
        amax = x.abs().amax(dim=-2, keepdim=True).clamp_min(torch.finfo(torch.float32).tiny)
        scale = torch.exp2(torch.ceil(torch.log2(amax / FP8_MAX)))
        w[idx] = ((x / scale).to(torch.float8_e4m3fn).float() * scale).to(w.dtype)


def fp8_base_(params: dict) -> None:
    for k in BASE_MATMULS:
        fp8_round_trip_(params["layers"][k], batch_axes=1)
    if "lm_head" in params:
        fp8_round_trip_(params["lm_head"], batch_axes=0)


def follow(job: dict, device, base: str = "bfloat16") -> dict:
    """Each party's first ``follow_steps`` local steps from the round's
    start: losses, the first gradient's and the change's norms by leaf, and
    every step's gradient norms by leaf.  ``base="fp8"``: the base rounded
    to float8 first (the control)."""
    full_precision()
    config, wl, seed = job["config"], job["workload"], job["seed"]
    opt = wl["optimizer"]
    params = traffic.llama_weights(config, seed, device, traffic.DTYPES[config["torch_dtype"]])
    if base == "fp8":
        fp8_base_(params)
    start = wire_round_trip(traffic.lora_adapters(config, wl["lora"], seed, device))
    out = {}
    for index, party in enumerate(wl["parties"]):
        rows = traffic.token_rows(config, wl, seed, index, device)
        lora = {"layers": {k: {"a": e["a"].clone(), "b": e["b"].clone(), "scale": e["scale"]}
                           for k, e in start["layers"].items()}}
        trained = [e[w] for e in lora["layers"].values() for w in ("a", "b")]
        m = [torch.zeros_like(p) for p in trained]
        v = [torch.zeros_like(p) for p in trained]
        losses, grad_norms = [], []
        for step in range(wl["follow_steps"]):
            for p in trained:
                p.requires_grad_(True)
            loss = loss_fn(params, lora, rows[step % rows.shape[0]], config)
            grads = torch.autograd.grad(loss, trained)
            losses.append(float(loss.detach()))
            gtree = {"layers": {k: {"a": None, "b": None, "scale": torch.zeros(())} for k in lora["layers"]}}
            it = iter(grads)
            for k in lora["layers"]:
                gtree["layers"][k]["a"], gtree["layers"][k]["b"] = next(it), next(it)
            grad_norms.append(leaf_norms(gtree))
            if step == 0:
                first = {k: g.detach().cpu() for k, g in tree_leaves(gtree)}
            t = step + 1
            with torch.no_grad():
                for j, (p, g) in enumerate(zip(trained, grads)):
                    p.requires_grad_(False)
                    m[j] = opt["b1"] * m[j] + (1 - opt["b1"]) * g
                    v[j] = opt["b2"] * v[j] + (1 - opt["b2"]) * g * g
                    mhat = m[j] / (1 - opt["b1"] ** t)
                    vhat = v[j] / (1 - opt["b2"] ** t)
                    p.sub_(opt["lr"] * mhat / (torch.sqrt(vhat) + opt["eps"]))
        out[party] = {"losses": losses, "grad1": grad_norms[0], "change": leaf_norms(lora, start),
                      "grad_norms": grad_norms, "grad1_tensors": first}
    return out


def control(job: dict, device) -> dict:
    """The cell's control: this reference with its base in float8 e4m3,
    one precision below the configuration's bfloat16, put in the program's
    place."""
    return follow(job, device, base="fp8")
