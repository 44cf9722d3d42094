"""Start a party's world of ranks on this host: one spawned process per rank.

:func:`run_world` is how the tests and ``chip_smoke.py`` run the
party-local parallel ops: every rank joins one ``torch.distributed`` world
(:func:`~rayfed_tpu_torch.parallel.collectives.init_world`, a loopback
rendezvous on a port from
:func:`~rayfed_tpu_torch.utils.ports.free_loopback_ports`), runs the same
function, and hands its result back.  A federated party of several
processes joins its world through :mod:`rayfed_tpu_torch.distributed`
instead (``fed.init(coordinator_address=...)``).
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import time
import traceback
from typing import Any, Callable, List, Optional

from rayfed_tpu_torch.utils.ports import free_loopback_ports


def _rank_main(fn, rank, world_size, port, device, args, out):
    import faulthandler

    import torch
    import torch.distributed as dist

    faulthandler.enable()  # a rank killed by a signal prints its stack
    if device is not None and torch.device(device).type == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores

    from rayfed_tpu_torch.parallel.collectives import init_world

    try:
        dev = init_world(rank, world_size, port, device=device)
        try:
            result = fn(rank, dev, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, "ok", result))
    except BaseException:  # reported to the parent, which fails the run
        out.put((rank, "error", traceback.format_exc()))
        raise


def run_world(
    fn: Callable,
    world_size: int,
    args: tuple = (),
    *,
    device: Optional[str] = None,
    timeout_s: float = 300.0,
) -> List[Any]:
    """Run ``fn(rank, device, *args)`` on ``world_size`` spawned ranks of
    one world; return their results in rank order.

    ``fn`` must be importable by name from a module that the ranks can
    import, and its result picklable (numpy arrays, not tensors).  The ranks
    run on the card (``device=None``: rank r on ``cuda:(r % count)``) unless
    ``device`` says otherwise (``"cpu"`` for a gloo world on the CPU).  A
    rank that raises, exits without a result or outlives ``timeout_s`` fails
    the run; every rank still running is then killed.
    """
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_loopback_ports(1)[0]
    procs = [ctx.Process(target=_rank_main, name=f"rank-{r}",
                         args=(fn, r, world_size, port, device, args, out))
             for r in range(world_size)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout_s
    try:
        while len(results) < world_size:  # drain the queue before joining
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(results))} "
                                   f"gave no result in {timeout_s} s")
            try:
                rank, status, value = out.get(timeout=1)
            except queue.Empty:
                gone = [r for r, p in enumerate(procs) if r not in results and not p.is_alive()]
                if gone:
                    raise RuntimeError(f"ranks {gone} exited {[procs[r].exitcode for r in gone]} "
                                       f"without a result")
                continue
            if status == "error":
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [results[r] for r in range(world_size)]
