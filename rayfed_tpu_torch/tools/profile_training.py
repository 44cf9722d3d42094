"""Where the LoRA training step's time goes on the card.

    python -m rayfed_tpu_torch.tools.profile_training [--int8]

Llama-3-8B at full width and depth (random bf16 base from a seed, remat;
with ``--int8`` an ``init_llama_int8`` base), LoRA rank 16 on wq/wv, B=1,
T=2048, flash attention, as ``chip_smoke.py`` drives it.  After one warm-up step, ``torch.profiler`` traces two steps and
prints the host wall time, the summed device kernel time, the device busy
share and the kernels that take the most device time.  Needs a CUDA card.
"""

from __future__ import annotations

import sys

import torch

from rayfed_tpu_torch.models import llama, lora
from rayfed_tpu_torch.ops.flash_attention import flash_attention
from rayfed_tpu_torch.tools.profile_serving import _report, _traced

SEED = 0
SEQ_LEN, RANK, STEPS = 2048, 16, 2


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_training needs a CUDA card")
    print(f"[card] {torch.cuda.get_device_name(0)}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cfg = llama.llama3_8b(param_dtype=torch.bfloat16, remat=True)
    init = llama.init_llama_int8 if "--int8" in sys.argv[1:] else llama.init_llama
    params = init(cfg, gen, device="cuda")
    adapters = lora.init_lora(params, lora.LoraConfig(rank=RANK), gen, device="cuda")
    opt = llama.init_adam(adapters)
    ids = torch.randint(0, cfg.vocab_size, (1, SEQ_LEN), generator=gen, device="cuda")
    step = llama.make_lora_train_step(cfg, lr=1e-3, attn_fn=flash_attention)
    adapters, opt, _ = step(adapters, opt, params, ids)  # warm-up

    def run():
        nonlocal adapters, opt
        for _ in range(STEPS):
            adapters, opt, loss = step(adapters, opt, params, ids)
        return loss

    _, prof, wall_ms = _traced(run)
    _report(f"lora train step x{STEPS}", prof, wall_ms, top=16)


if __name__ == "__main__":
    main()
