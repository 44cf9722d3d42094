"""Model FLOPs of the llama kind's LoRA step, and the work of a flash call.

A step's model FLOPs are the forward's products plus those of the backward
that the update needs, without recomputation: every product's input
gradient where something below it trains, the LoRA factors' gradients,
and attention over the pairs that the causal window leaves visible.  The
frozen base gets no weight gradient.
"""

from __future__ import annotations

from fedbench.traffic import llama_dims

PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def window_pairs(t: int, window=None) -> int:
    """(query, key) pairs with ``t − window < key ≤ query`` of one sequence."""
    if window is None or window >= t:
        return t * (t + 1) // 2
    return window * (window + 1) // 2 + (t - window) * window


def shapes(config: dict) -> dict:
    """``(d_in, d_out)`` of each projection of a layer."""
    n = llama_dims(config)
    q, kv, d, f = n["h"] * n["dh"], n["kv"] * n["dh"], n["d"], n["f"]
    return {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d), "w_gate": (d, f), "w_up": (d, f),
            "w_down": (f, d)}


def step_flops(config: dict, workload: dict, pairs=None) -> int:
    """Model FLOPs of one LoRA step of ``batch × seq_len`` tokens.

    Follows which activations need a gradient: none below the first LoRA
    target, since the base and the embedding are frozen.  ``pairs``: the
    attended (query, key) pairs of one sequence and head; by default those
    of the causal window."""
    n = llama_dims(config)
    b, t = workload["batch"], workload["seq_len"]
    tok = b * t
    r, targets = workload["lora"]["rank"], set(workload["lora"]["targets"])
    if pairs is None:
        pairs = window_pairs(t, config["sliding_window"])
    attn = 2 * b * n["h"] * pairs * n["dh"]  # one product over the pairs
    dims = shapes(config)

    def project(name, needs_in):
        """A projection's products; whether its output needs a gradient."""
        d_in, d_out = dims[name]
        out = 2 * tok * d_in * d_out * (2 if needs_in else 1)
        if name in targets:
            # forward x@A, (xA)@B; backward into xA, dB, dA, and into x
            out += 2 * tok * r * (d_in + d_out) + 2 * tok * r * (2 * d_out + d_in)
            out += 2 * tok * r * d_in if needs_in else 0
        return out, needs_in or name in targets

    total, stream = 0, False  # stream: the residual stream needs a gradient
    for _layer in range(n["L"]):
        fq, q = project("wq", stream)
        fk, k = project("wk", stream)
        fv, v = project("wv", stream)
        total += fq + fk + fv + 2 * attn  # S = QKᵀ, PV
        total += attn * ((q or k) + q + k + v)  # dP, dQ, dK, dV
        fo, o = project("wo", q or k or v)
        stream = stream or o
        fg, g = project("w_gate", stream)
        fu, u = project("w_up", stream)
        fd, d = project("w_down", g or u)
        total += fo + fg + fu + fd
        stream = stream or d
    return total + 2 * tok * n["d"] * n["V"] * (2 if stream else 1)  # the head


def flash_call(config: dict, workload: dict, backward: bool = False) -> tuple:
    """``(flops, bytes)`` that one flash call's work needs: the forward's two
    products over the visible pairs, or the backward's five (S again, dP,
    dV, dQ, dK); q, k, v (and o, dO, lse) read once, the outputs written once,
    in bfloat16 with float32 row statistics."""
    n = llama_dims(config)
    b, t = workload["batch"], workload["seq_len"]
    pairs = window_pairs(t, config["sliding_window"])
    plane = 2 * b * t * n["h"] * n["dh"]  # one [B, T, H, dh] bfloat16 tensor
    rows = 4 * b * n["h"] * t
    if backward:
        return 10 * b * n["h"] * pairs * n["dh"], 8 * plane + 2 * rows
    return 4 * b * n["h"] * pairs * n["dh"], 4 * plane + rows
