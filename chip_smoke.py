"""Smoke run of the PyTorch/CUDA port (rayfed_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build the CUDA kernels from the sources in the checkout;
  2. hold each kernel against its plain PyTorch version on the card, at the
     main path's shapes and at the edge cases (window, offsets with fully
     masked rows, ragged T, head dim 64, f32 in/out);
  3. drive the main path: Llama-3-8B at full width and depth (random bf16
     weights from a seed) serving 4 prompts of 2048 tokens, 32 greedy new
     tokens each, with flash-attention prefill; check the kernel ran once
     per layer, the outputs are sane, and batch-1 prefill logits agree
     with the dense-attention path;
  4. time each kernel against its plain version, the library call that
     computes the same function, and the card's bound.
Prints the card (nvidia-smi), a JSON line of kernel numbers and, last, the
result line.  Exits non-zero without a result when there is no CUDA card.
Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from rayfed_tpu_torch.models import llama
from rayfed_tpu_torch.ops import _build
from rayfed_tpu_torch.ops.attention import dot_product_attention
from rayfed_tpu_torch.ops.flash_attention import (
    NEG_INF,
    _flash_forward,
    _flash_forward_reference,
    flash_attention,
)

SEED = 0
BATCH, PROMPT_LEN, NEW_TOKENS = 4, 2048, 32
# Dense peaks of the H100 (NVIDIA data sheet): bf16 tensor-core FLOP/s, HBM bytes/s.
PEAKS = {"PCIe": (756e12, 2.0e12), "NVL": (835e12, 3.9e12), "SXM": (989e12, 3.35e12)}
# Tolerances of the kernel vs its plain version.  f32 inputs: summation
# order only.  bf16 outputs: the two round p and o to bf16 at different
# running maxima, so o may differ by up to two bf16 ulps; lse is f32 from
# exact bf16 products.
TOL = {
    torch.float32: dict(o_atol=1e-4, o_rtol=1e-4, lse_atol=1e-4),
    torch.bfloat16: dict(o_atol=1e-2, o_rtol=2.0**-6, lse_atol=1e-3),
}
# Batch-1 prefill logits through the kernel vs through dense attention,
# after 32 bf16 layers: the two paths round attention differently, so the
# gap is held to 5% of the logits' range (a wrong mask moves them by ~100%).
LOGIT_REL_TOL = 0.05


def _sync_ms(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _peaks(name):
    for key, peaks in PEAKS.items():
        if key in name:
            return key, peaks
    return "SXM", PEAKS["SXM"]


def phase_build():
    t0 = time.perf_counter()
    path = _build.build("flash_fwd")
    _build.flash_fwd_lib()
    print(f"[build] flash_fwd -> {path.name} in {time.perf_counter() - t0:.2f} s")
    log = _build.log_path("flash_fwd")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")


def _qkv(gen, bh, t_q, t_k, d, dtype):
    def rand(t):
        return torch.randn(bh, t, d, generator=gen, device="cuda").to(dtype)

    return rand(t_q), rand(t_k), rand(t_k)


def phase_kernel_vs_plain(gen):
    """Returns the max abs error on o at the main path's shape."""
    bh = BATCH * 32
    cases = [
        # name, bh, t_q, t_k, d, dtype, out_dtype, causal, q_offset, kv_offset, window
        ("slice_causal", bh, 2048, 2048, 128, torch.bfloat16, None, True, 0, 0, None),
        ("causal_window512", bh, 2048, 2048, 128, torch.bfloat16, None, True, 0, 0, 512),
        ("offsets_masked_rows", 32, 1024, 1536, 128, torch.bfloat16, None, True, 128, 384, None),
        ("ragged_T1000", bh, 1000, 1000, 128, torch.bfloat16, None, True, 0, 0, None),
        ("d64", bh, 2048, 2048, 64, torch.bfloat16, None, True, 0, 0, None),
        ("f32_in_f32_out", 32, 1024, 1024, 128, torch.float32, torch.float32, True, 0, 0, None),
    ]
    slice_err = None
    for name, bh_, t_q, t_k, d, dtype, out_dtype, causal, q_off, kv_off, window in cases:
        q, k, v = _qkv(gen, bh_, t_q, t_k, d, dtype)
        kw = dict(scale=d**-0.5, causal=causal, q_offset=q_off, kv_offset=kv_off,
                  out_dtype=out_dtype, window=window)
        o, lse = _flash_forward(q, k, v, **kw)
        torch.cuda.synchronize()
        o_ref, lse_ref = _flash_forward_reference(q, k, v, **kw)
        tol = TOL[dtype]
        diff = (o.float() - o_ref.float()).abs()
        o_ok = bool(torch.all(diff <= tol["o_atol"] + tol["o_rtol"] * o_ref.float().abs()))
        lse_err = (lse - lse_ref).abs().max().item()
        masked = lse_ref <= NEG_INF / 2
        rows_ok = torch.equal(masked, lse <= NEG_INF / 2) and bool(torch.all(o[masked] == 0))
        abs_err = diff.max().item()
        rel_err = abs_err / o_ref.float().abs().max().item()
        print(
            f"[kernel] {name}: o max_abs_err={abs_err:.3e} max_rel_err={rel_err:.3e} "
            f"(tol {tol['o_atol']:g} + {tol['o_rtol']:g}*|ref|) lse max_abs_err={lse_err:.3e} "
            f"(tol {tol['lse_atol']:g}) fully_masked_rows={int(masked.sum())}"
        )
        if not (o_ok and lse_err <= tol["lse_atol"] and rows_ok and o.dtype == o_ref.dtype):
            raise AssertionError(f"flash_fwd disagrees with its plain version in case {name}")
        if name == "slice_causal":
            slice_err = abs_err
        del q, k, v, o, lse, o_ref, lse_ref, diff
        torch.cuda.empty_cache()
    return slice_err


def phase_slice(gen):
    cfg = llama.llama3_8b(param_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = llama.init_llama(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(w.numel() for w in params["layers"].values()) + sum(
        params[k].numel() for k in ("embed", "final_norm", "lm_head")
    )
    print(f"[slice] llama3_8b: {n_params / 1e9:.3f}e9 bf16 params initialised in "
          f"{time.perf_counter() - t0:.1f} s")
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN), generator=gen, device="cuda")

    torch.cuda.reset_peak_memory_stats()
    flash_attention.fwd_launches = 0
    t0 = time.perf_counter()
    out = llama.generate(params, cfg, prompts, NEW_TOKENS, attn_fn=flash_attention)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    launches = flash_attention.fwd_launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[slice] generate B={BATCH} T0={PROMPT_LEN} new={NEW_TOKENS}: {generate_s * 1e3:.1f} ms "
          f"(first call), flash_fwd launches={launches}, max_memory_allocated={peak_gb:.2f} GB")
    if launches != cfg.num_layers:
        raise AssertionError(f"expected {cfg.num_layers} flash_fwd launches, got {launches}")
    if out.shape != (BATCH, PROMPT_LEN + NEW_TOKENS) or not torch.equal(out[:, :PROMPT_LEN], prompts):
        raise AssertionError(f"generate returned {tuple(out.shape)} or altered the prompt")
    new = out[:, PROMPT_LEN:]
    if not bool(torch.all((new >= 0) & (new < cfg.vocab_size))):
        raise AssertionError("generated token ids out of range")

    # Steady-state split: prefill alone, then the decode steps.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, logits = llama.prefill(params, cfg, prompts, PROMPT_LEN + NEW_TOKENS,
                                  attn_fn=flash_attention)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    if not bool(torch.isfinite(logits).all()) or logits.shape != (BATCH, cfg.vocab_size):
        raise AssertionError("prefill logits are not finite [B, V]")
    step = llama.make_decode_step(cfg)
    token = logits.argmax(dim=-1)
    t0 = time.perf_counter()
    for i in range(NEW_TOKENS):
        cache, logits = step(params, cache, token, PROMPT_LEN + i)
        token = logits.argmax(dim=-1)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / NEW_TOKENS
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("decode logits are not finite")
    print(f"[slice] prefill {prefill_ms:.1f} ms ({BATCH * PROMPT_LEN / prefill_ms * 1e3:.0f} prompt tok/s); "
          f"decode {decode_ms:.2f} ms/token step ({BATCH * 1e3 / decode_ms:.1f} tok/s at B={BATCH})")
    del cache, logits

    one = prompts[:1]
    _, via_flash = llama.prefill(params, cfg, one, PROMPT_LEN, attn_fn=flash_attention)
    _, via_dense = llama.prefill(params, cfg, one, PROMPT_LEN, attn_fn=dot_product_attention)
    gap = (via_flash - via_dense).abs().max().item()
    span = via_dense.abs().max().item()
    same_top = bool(torch.equal(via_flash.argmax(-1), via_dense.argmax(-1)))
    print(f"[slice] B=1 prefill logits, flash vs dense: max_abs_diff={gap:.4e} "
          f"max|logit|={span:.4e} (tol {LOGIT_REL_TOL:g}*max|logit|), same argmax={same_top}")
    if not gap <= LOGIT_REL_TOL * span:
        raise AssertionError("flash prefill logits disagree with the dense path")
    del params
    torch.cuda.empty_cache()
    return launches


def phase_times(gen, card):
    b, h, t, d = BATCH, 32, PROMPT_LEN, 128
    q, k, v = _qkv(gen, b * h, t, t, d, torch.bfloat16)
    scale = d**-0.5
    ms = _sync_ms(lambda: _flash_forward(q, k, v, scale=scale, causal=True), iters=20)
    plain_ms = _sync_ms(lambda: _flash_forward_reference(q, k, v, scale=scale, causal=True), iters=5)
    q4, k4, v4 = (x.view(b, h, t, d) for x in (q, k, v))
    library_ms = _sync_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True), iters=20)
    kind, (flops_peak, bytes_peak) = _peaks(card)
    pairs = t * (t + 1) // 2  # visible (q, k) pairs of one causal head
    flops = 4 * b * h * d * pairs  # Q·Kᵀ and P·V
    nbytes = 4 * b * h * t * d * 2 + b * h * t * 4  # q, k, v, o in bf16 + f32 lse
    flop_ms, byte_ms = flops / flops_peak * 1e3, nbytes / bytes_peak * 1e3
    bound_ms, bound_by = (flop_ms, "operations") if flop_ms >= byte_ms else (byte_ms, "bytes")
    print(f"[times] flash_fwd B={b} H={h} T={t} D={d} causal bf16: kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, sdpa {library_ms:.3f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}; H100 {kind} peaks; {flops / ms / 1e9:.1f} TFLOP/s achieved)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    print(f"[card] {card}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    phase_build()
    slice_err = phase_kernel_vs_plain(gen)
    launches = phase_slice(gen)
    times = phase_times(gen, card)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip())
    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "rayfed_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "rayfed_tpu/ops/flash_attention.py:84",
        "launches": launches,
        "max_abs_err": slice_err,
        **times,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
