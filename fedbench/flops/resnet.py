"""Model FLOPs of the resnet kind's SGD step: each convolution's and the
head's forward product, its weight gradient, and its input gradient except
the stem's, whose input is the images."""

from __future__ import annotations

from fedbench.traffic import resnet_blocks


def convolutions(config: dict) -> list:
    """``(out_h, out_w, k, c_in, c_out)`` of every convolution, the stem first."""
    size, w = config["image_size"], config["width"]
    stem_stride = 1 if config["small_inputs"] else 2
    size = -(-size // stem_stride)
    out = [(size, size, 3 if config["small_inputs"] else 7, config["channels"], w)]
    if not config["small_inputs"]:
        size = -(-size // 2)
    for _name, stride, c_in, c_out in resnet_blocks(config):
        o = -(-size // stride)
        out.append((o, o, 3, c_in, c_out))
        out.append((o, o, 3, c_out, c_out))
        if stride != 1 or c_in != c_out:
            out.append((o, o, 1, c_in, c_out))
        size = o
    return out


def step_flops(config: dict, workload: dict) -> int:
    b = workload["batch"]
    convs = [2 * b * oh * ow * k * k * ci * co for oh, ow, k, ci, co in convolutions(config)]
    head = 2 * b * config["width"] * 2 ** (len(config["stage_sizes"]) - 1) * config["num_classes"]
    return 3 * sum(convs) - convs[0] + 3 * head
