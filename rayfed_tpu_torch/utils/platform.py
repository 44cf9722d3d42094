"""Device selection for the port's entry points.

Entry points run on the CUDA card.  The CPU is used only when the caller
asks for it (the tests do): a host without a card never falls back to the
CPU silently.  Values handed from one thread to another (a task's result
to the transport) are ordered on the card by :func:`fence_for_handoff`.
"""

from __future__ import annotations

from typing import Any, Optional, Union

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


def fence_for_handoff(value: Any, record_events: bool = False) -> Optional[list]:
    """Order the work that produced ``value``'s CUDA tensors before what is
    enqueued later on their devices' default streams.

    Call it on the thread that produced ``value``, when handing it to
    another thread: the transport copies a pushed tensor to the host on
    its device's default stream, from a thread of its own.  When this
    thread's current stream is not the default one, the default stream
    waits on an event recorded on it now; on the default stream the order
    holds already.

    With ``record_events`` (the flight recorder's ``exec.device``) it also
    returns one event a device, recorded on this thread's current stream
    after the fence: the card has finished the work ``value`` depends on
    once it has passed them.  Otherwise it returns None.
    """
    if not torch.cuda.is_initialized():
        return None
    from rayfed_tpu_torch import tree_util

    devices = {
        leaf.device
        for leaf in tree_util.tree_leaves(value)
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda
    }
    events = [] if record_events else None
    for dev in devices:
        current = torch.cuda.current_stream(dev)
        default = torch.cuda.default_stream(dev)
        if current != default:
            default.wait_stream(current)
        if events is not None:
            ev = torch.cuda.Event(blocking=True)
            ev.record(current)
            events.append(ev)
    return events
