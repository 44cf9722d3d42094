"""Single-card Llama serving on the PyTorch port: int8 weights, sliding
window, rolling cache.

Demonstrates the inference stack end-to-end on a tiny config (swap in
``llama3_8b()`` + ``models.hf`` weights for a real model):

1. int8-quantize the base (half the HBM reads per token);
2. batched prefill of the prompt;
3. token-at-a-time decode through an O(window) rolling KV cache —
   memory stays constant no matter how long the generation runs.

    python examples_torch/serve_llama.py

The program of ``examples/serve_llama.py``; its random draws come
from ``torch.Generator``s seeded with that file's seeds.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

PROMPT_LEN = 12
NEW_TOKENS = 24
WINDOW = 16
BATCH = 2


def config():
    from rayfed_tpu_torch.models import llama

    return llama.llama_tiny(sliding_window=WINDOW, kv_quant=True)


def serve(params, cfg, prompt, new_tokens: int):
    """Greedy generation: prefill ``prompt`` [B, PROMPT_LEN], roll the cache
    into the W-slot ring, then ``new_tokens`` rolling decode steps.  Returns
    the tokens [B, new_tokens] and the ring cache's bytes."""
    import torch

    from rayfed_tpu_torch.models import llama

    # Prefill at prompt length, then shrink to the O(window) ring.
    cache, logits = llama.prefill(params, cfg, prompt, PROMPT_LEN)
    cache = llama.roll_kv_cache(cache, cfg, PROMPT_LEN)
    step = llama.make_decode_step(cfg, rolling=True)

    cache_bytes = sum(v.nbytes for v in cache.values())
    tokens = []
    tok = torch.argmax(logits, dim=-1).to(prompt.dtype)
    for i in range(new_tokens):
        tokens.append(tok)
        cache, logits = step(params, cache, tok, PROMPT_LEN + i)
        tok = torch.argmax(logits, dim=-1).to(prompt.dtype)
    return torch.stack(tokens, dim=1), cache_bytes


def run(new_tokens: int = NEW_TOKENS, device=None) -> int:
    """Serve ``new_tokens`` tokens on ``device`` (``None``: the CUDA card,
    raising without one); returns the number generated per sequence."""
    import torch

    from rayfed_tpu_torch.models import llama
    from rayfed_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    cfg = config()
    params = llama.quantize_llama_base(
        llama.init_llama(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    )
    prompt = torch.randint(
        0, cfg.vocab_size, (BATCH, PROMPT_LEN),
        generator=torch.Generator(device=dev).manual_seed(1), device=dev,
    )

    out, cache_bytes = serve(params, cfg, prompt, new_tokens)
    print(
        f"served {out.shape[0]}x{out.shape[1]} tokens on {dev}; int8 base, "
        f"W={WINDOW} rolling cache pinned at {cache_bytes / 1e6:.3f} MB "
        f"(independent of generation length)",
        flush=True,
    )
    assert out.shape == (BATCH, new_tokens)
    return int(out.shape[1])


if __name__ == "__main__":
    run()
