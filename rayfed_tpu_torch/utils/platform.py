"""Device selection for the port's entry points.

Entry points run on the CUDA card.  The CPU is used only when the caller
asks for it (the tests do): a host without a card never falls back to the
CPU silently.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the current CUDA card and raises ``RuntimeError`` when
    there is none; ``"cpu"`` (or any explicit device) is returned as given.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())
