"""Plain float32 reference of the resnet kind: SGD-with-momentum steps.

ResNet v1.5 on NHWC images with HWIO kernels: a stem convolution, residual
blocks of two 3×3 convolutions (stride 2 at the first block of every stage
after the first, with a 1×1 projection where the shape changes), batch
norm with the batch's statistics (biased variance), ReLU, global average
pooling and a linear head; the mean softmax cross entropy.  Padding is
"SAME" as XLA defines it: where the total is odd the extra pixel goes at
the end.  A step is ``m = momentum·m + g``, ``p = p − lr·m``, the momentum
fresh at the start of a round.  Float32, TF32 off.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fedbench import traffic
from fedbench.judge import leaf_norms, tree_leaves
from fedbench.reference import full_precision, wire_round_trip


def same_pads(n: int, k: int, stride: int) -> tuple:
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv(x, w, stride=1):
    ph, pw = same_pads(x.shape[1], w.shape[0], stride), same_pads(x.shape[2], w.shape[1], stride)
    xc = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride).permute(0, 2, 3, 1)


def batch_norm(x, p, eps):
    mean = x.mean(dim=(0, 1, 2))
    var = x.var(dim=(0, 1, 2), unbiased=False)
    return (x - mean) * (torch.rsqrt(var + eps) * p["scale"]) + p["bias"]


def forward(params, x, config):
    eps = config["bn_eps"]
    x = conv(x, params["stem"]["conv"], 1 if config["small_inputs"] else 2)
    x = torch.relu(batch_norm(x, params["stem"]["bn"], eps))
    if not config["small_inputs"]:
        ph, pw = same_pads(x.shape[1], 3, 2), same_pads(x.shape[2], 3, 2)
        xc = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
        x = F.max_pool2d(xc, 3, 2).permute(0, 2, 3, 1)
    for name, stride, _c_in, _c_out in traffic.resnet_blocks(config):
        bp = params[name]
        y = torch.relu(batch_norm(conv(x, bp["conv1"], stride), bp["bn1"], eps))
        y = batch_norm(conv(y, bp["conv2"]), bp["bn2"], eps)
        skip = batch_norm(conv(x, bp["proj"], stride), bp["proj_bn"], eps) if "proj" in bp else x
        x = torch.relu(y + skip)
    return x.mean(dim=(1, 2)) @ params["head"]["kernel"] + params["head"]["bias"]


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree, k


def follow(job: dict, device) -> dict:
    """Each party's first ``follow_steps`` local steps from the round's start."""
    full_precision()
    config, wl, seed = job["config"], job["workload"], job["seed"]
    opt = wl["optimizer"]
    params0, _state = traffic.resnet_weights(config, seed, device)
    start = wire_round_trip(params0)
    out = {}
    for index, party in enumerate(wl["parties"]):
        x_all, y_all = traffic.images(config, wl, seed, index, device)
        params = wire_round_trip(params0)
        slots = list(_flat(params))
        mom = {path: torch.zeros_like(node[k]) for path, node, k in slots}
        losses, grad_norms = [], []
        for step in range(wl["follow_steps"]):
            x, y = traffic.image_batch(wl, x_all, y_all, step)
            leaves = [node[k].requires_grad_(True) for _path, node, k in slots]
            loss = F.cross_entropy(forward(params, x, config), y)
            grads = torch.autograd.grad(loss, leaves)
            losses.append(float(loss.detach()))
            gtree: dict = {}
            for (path, _node, _k), g in zip(slots, grads):
                node = gtree
                *head, last = path.split("/")
                for part in head:
                    node = node.setdefault(part, {})
                node[last] = g
            grad_norms.append(leaf_norms(gtree))
            if step == 0:
                first = {k: g.detach().cpu() for k, g in tree_leaves(gtree)}
            with torch.no_grad():
                for (path, node, k), g in zip(slots, grads):
                    mom[path] = opt["momentum"] * mom[path] + g
                    node[k] = node[k].detach() - opt["lr"] * mom[path]
        out[party] = {"losses": losses, "grad1": grad_norms[0], "change": leaf_norms(params, start),
                      "grad_norms": grad_norms,
                      "grad1_tensors": first}
    return out
