"""Where the serving path's time goes on the card.

    python -m rayfed_tpu_torch.tools.profile_serving [--int8]

Llama-3-8B at full width and depth (random bf16 weights from a seed), 4
prompts of 2048 tokens, as ``chip_smoke.py`` drives it; with ``--int8`` its
int8 serving path instead (an ``init_llama_int8`` base, the int8 KV cache,
a 1024-token window, the decode on a rolling ring).  After one warm-up
``generate``, ``torch.profiler`` traces one flash-attention prefill and then
8 decode steps.  For each it prints the host wall time, the summed device
kernel time, the device busy share (kernel time / wall time) and the kernels
that take the most device time.  Needs a CUDA card.
"""

from __future__ import annotations

import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from rayfed_tpu_torch.models import llama
from rayfed_tpu_torch.ops.flash_attention import flash_attention

SEED = 0
BATCH, PROMPT_LEN, DECODE_STEPS = 4, 2048, 8
WINDOW = 1024  # the int8 path's sliding window (chip_smoke.SERVE_WINDOW)


def _report(name, prof, wall_ms, top=12):
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"[{name}] wall {wall_ms:.2f} ms, device kernels {busy_ms:.2f} ms, "
          f"busy share {busy_ms / wall_ms:.3f}, kernel launches "
          f"{sum(e.count for e in kernels)}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3
        print(f"[{name}]   {ms:9.3f} ms {ms / busy_ms:6.1%} x{e.count:<5d} {e.key[:90]}")


def _traced(fn):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return out, prof, wall_ms


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a CUDA card")
    print(f"[card] {torch.cuda.get_device_name(0)}")
    int8 = "--int8" in sys.argv[1:]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    if int8:
        cfg = llama.llama3_8b(param_dtype=torch.bfloat16, kv_quant=True, sliding_window=WINDOW)
        params = llama.init_llama_int8(cfg, gen, device="cuda")
    else:
        cfg = llama.llama3_8b(param_dtype=torch.bfloat16)
        params = llama.init_llama(cfg, gen, device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN), generator=gen, device="cuda")
    max_len = PROMPT_LEN + DECODE_STEPS
    llama.generate(params, cfg, prompts, DECODE_STEPS, attn_fn=flash_attention)  # warm-up

    (cache, logits), prof, wall_ms = _traced(
        lambda: llama.prefill(params, cfg, prompts, max_len, attn_fn=flash_attention)
    )
    _report("prefill", prof, wall_ms)

    step = llama.make_decode_step(cfg, rolling=int8)
    if int8:
        cache = llama.roll_kv_cache(cache, cfg, PROMPT_LEN)

    def decode():
        nonlocal cache, logits
        for i in range(DECODE_STEPS):
            cache, logits = step(params, cache, logits.argmax(dim=-1), PROMPT_LEN + i)

    _, prof, wall_ms = _traced(decode)
    _report(f"decode x{DECODE_STEPS}", prof, wall_ms)


if __name__ == "__main__":
    main()
