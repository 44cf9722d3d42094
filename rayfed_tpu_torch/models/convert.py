"""Carry Llama weights across from the reference's param tree.

The reference's params are a nested dict of arrays; converted to numpy
(``np.asarray`` per leaf) they arrive here and leave as the same tree of
torch tensors, key for key, since the port keeps the reference's names and
``x @ w`` orientation.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from rayfed_tpu_torch.utils.platform import resolve_device


def _leaf(x: Any, device: torch.device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.ascontiguousarray(x)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy rejects: carry the
        # 16-bit patterns across unchanged (a float round trip could not
        # be bit-exact).  np.array copies, so the tensor owns its memory.
        t = torch.from_numpy(np.array(a.view(np.uint16))).view(torch.bfloat16)
    elif a.dtype.kind in "fiub":
        t = torch.from_numpy(np.array(a))
    else:
        raise TypeError(f"cannot convert a leaf of dtype {a.dtype}")
    t = t.to(device)
    return t if dtype is None else t.to(dtype)


def llama_params_from_jax(
    tree: Any,
    device: Optional[torch.device] = None,
    dtype: Optional[torch.dtype] = None,
) -> Any:
    """The reference's Llama param tree (numpy leaves) as torch tensors.

    ``dtype`` casts every leaf (default: keep each leaf's dtype, bf16
    bit-exact).  Runs on the card unless ``device`` says otherwise.
    """
    device = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return _leaf(node, device, dtype)

    return convert(tree)
