"""The llama kind's trainer: LoRA fine-tuning of a frozen base through
``rayfed_tpu_torch.models.llama.make_lora_train_step`` on the flash kernels.

A party's actor holds the base (made from the seed, or with
``control.int8`` the program's own int8 form of it), its pool of token rows and its Adam state, which it keeps
across rounds.  ``train`` takes the round's packed wire form, runs the
cell's local steps, one new row each, and returns the packed adapters.
It keeps what the correctness check reads: the first ``follow_steps``
losses, Adam's first moment after step 1 and the adapters after the last
followed step.
"""

from __future__ import annotations

import time

import torch

from fedbench import traffic
from fedbench.judge import leaf_norms, tree_leaves

LOCAL: dict = {}  # this process's trainer, by party


def port_config(config: dict, workload: dict):
    from rayfed_tpu_torch.models import llama

    dtype = traffic.DTYPES[config["torch_dtype"]]
    return llama.LlamaConfig(
        vocab_size=config["vocab_size"], hidden_size=config["hidden_size"],
        num_layers=config["num_hidden_layers"], num_heads=config["num_attention_heads"],
        num_kv_heads=config["num_key_value_heads"], intermediate_size=config["intermediate_size"],
        rope_theta=float(config["rope_theta"]), rms_eps=config["rms_norm_eps"], max_seq_len=workload["seq_len"],
        tie_embeddings=config.get("tie_word_embeddings", False), dtype=dtype, param_dtype=dtype,
        remat=config["remat"], sliding_window=config["sliding_window"],
    )


def int8_base(params: dict) -> dict:
    """The program's own int8 base (``quantize_llama_base``),
    a layer of a leaf at a time, each float leaf dropped once quantized, so
    that the temporaries fit beside the other party's base.  The scales are
    per (layer, output channel): a layer quantizes alone as it does in the
    stack.  Empties ``params``."""
    from rayfed_tpu_torch.models import llama
    from rayfed_tpu_torch.models.quant import QTensor

    layers = params.pop("layers")
    out = llama.quantize_llama_base({**params, "layers": {}})
    params.clear()
    out["layers"] = {}
    for k in list(layers):
        v = layers.pop(k)
        parts = [llama.quantize_llama_base({"layers": {k: v[i:i + 1]}})["layers"][k] for i in range(v.shape[0])]
        if isinstance(parts[0], QTensor):
            v = QTensor(q=torch.cat([p.q for p in parts]), scale=torch.cat([p.scale for p in parts]))
        out["layers"][k] = v
        del parts
    return out


def initial(job: dict, device) -> dict:
    return traffic.lora_adapters(job["config"], job["workload"]["lora"], job["seed"], device)


class Trainer:
    def __init__(self, job: dict, index: int):
        from rayfed_tpu_torch.models import llama
        from rayfed_tpu_torch.ops.flash_attention import flash_attention

        wl, config = job["workload"], job["config"]
        self.party, self.variant, self.wl = wl["parties"][index], job["variant"], wl
        device = torch.device(job["device"])
        self.params = traffic.llama_weights(config, job["seed"], device, traffic.DTYPES[config["torch_dtype"]])
        if self.variant == "control.int8":
            self.params = int8_base(self.params)
        self.rows = traffic.token_rows(config, wl, job["seed"], index, device)
        opt = wl["optimizer"]
        self.step_fn = llama.make_lora_train_step(port_config(config, wl), lr=opt["lr"], attn_fn=flash_attention,
                                                  b1=opt["b1"], b2=opt["b2"], eps=opt["eps"])
        self.init_adam = llama.init_adam
        self.opt, self.k, self.last_out = None, 0, None
        self.losses, self.start, self.m1, self.after = [], None, None, None
        self.spans: list = []
        LOCAL[self.party] = self

    def train(self, wire):
        from rayfed_tpu_torch import fl

        t0, w0 = time.perf_counter(), time.time()
        adapters = fl.decompress(wire)
        if self.opt is None:
            self.opt, self.start = self.init_adam(adapters), adapters
        follow = self.wl["follow_steps"]
        for _ in range(self.wl["local_steps"]):
            ids = self.rows[self.k % self.rows.shape[0]]
            if self.variant == "fault.half_batch":
                ids = ids[:, : ids.shape[1] // 2]
            new, opt, loss = self.step_fn(adapters, self.opt, self.params, ids)
            if self.variant != "fault.state_unchanged":
                adapters, self.opt = new, opt
            self.k += 1
            if self.k <= follow:
                self.losses.append(loss)
            if self.k == 1:
                self.m1 = self.opt[1]
            if self.k == follow:
                self.after = adapters
        self.last_out = fl.compress(adapters, packed=True)
        self.spans.append([self.party, None, None, "trainer.train", None, None, 0, w0,
                           time.perf_counter() - t0, "ok", {}])
        return self.last_out

    def grad1(self) -> dict:
        """The first gradient as Adam got it: its first moment over (1 − b1)."""
        b1 = self.wl["optimizer"]["b1"]
        return {k: v.float() / (1 - b1) for k, v in tree_leaves(self.m1)}

    def follow_report(self) -> dict:
        b1 = self.wl["optimizer"]["b1"]
        grad1 = {k: v / (1 - b1) for k, v in leaf_norms(self.m1).items()}
        return {"losses": [float(x) for x in self.losses], "grad1": grad1,
                "change": leaf_norms(self.after, self.start)}
