"""The resnet kind's trainer: image classification through
``rayfed_tpu_torch.models.resnet.make_train_step`` (SGD with momentum).

A party's actor holds its shard of images from the seed.  ``train`` takes
the round's packed ``(params, batch-norm state)``, starts a fresh
momentum, as ``resnet.make_fed_train_step`` does, runs the cell's local
steps, one new batch each, and returns the packed result.  It keeps what
the correctness check reads: the first ``follow_steps`` losses, the
momentum after step 1 (the first gradient) and the params after the last
followed step.  The control runs the program's bfloat16 path.
"""

from __future__ import annotations

import time

import torch

from fedbench import traffic
from fedbench.judge import leaf_norms, tree_leaves

LOCAL: dict = {}


def port_config(config: dict, dtype: torch.dtype):
    from rayfed_tpu_torch.models import resnet

    return resnet.ResNetConfig(
        stage_sizes=tuple(config["stage_sizes"]), num_classes=config["num_classes"], width=config["width"],
        small_inputs=config["small_inputs"], bn_momentum=config["bn_momentum"], bn_eps=config["bn_eps"],
        dtype=dtype,
    )


def initial(job: dict, device) -> tuple:
    return traffic.resnet_weights(job["config"], job["seed"], device)


class Trainer:
    def __init__(self, job: dict, index: int):
        from rayfed_tpu_torch.models import resnet

        wl, config = job["workload"], job["config"]
        self.party, self.variant, self.wl = wl["parties"][index], job["variant"], wl
        device = torch.device(job["device"])
        dtype = torch.bfloat16 if self.variant == "control" else traffic.DTYPES[config["dtype"]]
        self.x, self.y = traffic.images(config, wl, job["seed"], index, device)
        opt = wl["optimizer"]
        self.step_fn = resnet.make_train_step(port_config(config, dtype), lr=opt["lr"], momentum=opt["momentum"])
        self.init_opt = resnet.init_opt_state
        self.k, self.last_out = 0, None
        self.losses, self.start, self.g1, self.after = [], None, None, None
        self.spans: list = []
        LOCAL[self.party] = self

    def train(self, wire):
        from rayfed_tpu_torch import fl

        t0, w0 = time.perf_counter(), time.time()
        params, state = fl.decompress(wire)
        opt = self.init_opt(params)
        if self.start is None:
            self.start = params
        follow = self.wl["follow_steps"]
        for _ in range(self.wl["local_steps"]):
            x, y = traffic.image_batch(self.wl, self.x, self.y, self.k)
            if self.variant == "fault.half_batch":
                x, y = x[: x.shape[0] // 2], y[: y.shape[0] // 2]
            new = self.step_fn(params, state, opt, x, y)
            loss = new[3]
            if self.variant != "fault.state_unchanged":
                params, state, opt = new[:3]
            self.k += 1
            if self.k <= follow:
                self.losses.append(loss)
            if self.k == 1:
                self.g1 = opt
            if self.k == follow:
                self.after = params
        self.last_out = fl.compress((params, state), packed=True)
        self.spans.append([self.party, None, None, "trainer.train", None, None, 0, w0,
                           time.perf_counter() - t0, "ok", {}])
        return self.last_out

    def grad1(self) -> dict:
        """The first gradient as SGD got it: the momentum after step 1."""
        return dict(tree_leaves(self.g1))

    def follow_report(self) -> dict:
        return {"losses": [float(x) for x in self.losses], "grad1": leaf_norms(self.g1),
                "change": leaf_norms(self.after, self.start)}
