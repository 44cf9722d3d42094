"""The party driver: what one party process of a cell runs.

Every party process runs :func:`party_main` with the same job.  It joins
the federation (``rayfed_tpu_torch.init``), builds the trainer actors of
the configuration's kind (``fedbench/party/<kind>.py``) and runs
``rayfed_tpu_torch.fl.run_fedavg_rounds`` with the cell's round options.
After each round every party asks the coordinator whether the window is
open, running or closed (``_decide`` runs there, on its clock), so all of
them stop after the same round: the warm-up rounds, then whole rounds
until ``seconds`` have passed, the window ending with the round that
crosses it.  With ``trace`` the profiler runs from the last warm-up round
over the first ``traced_rounds`` rounds of the window.

This package is the only part of the benchmark that imports the program.
"""

from __future__ import annotations

import os
import sys
import time
import traceback

MAX_ROUNDS = 1_000_000
FORBIDDEN = ("jax", "jaxlib", "flax", "rayfed_tpu")

# At the coordinator: the window's bounds on its clock.
WINDOW: dict = {}


def _decide(r: int, warm: int, seconds: float) -> str:
    now = time.time()
    if r < warm - 1:
        return "warm"
    if r == warm - 1:
        WINDOW.update(t0=now, r0=r)
        return "open"
    if now - WINDOW["t0"] >= seconds:
        WINDOW.update(t1=now, r1=r)
        return "stop"
    return "go"


class _Closed(Exception):
    def __init__(self, current):
        super().__init__("window closed")
        self.current = current


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def party_main(party: str, job: dict, out) -> None:
    try:
        out.put(_run(party, job))
    except BaseException:
        out.put({"party": party, "error": traceback.format_exc()})
        raise


def _plant(job: dict, party: str, kind) -> None:
    """The faults that the correctness tests plant under the timed path."""
    variant = job["variant"]
    if variant not in ("fault.altered", "fault.no_exchange"):
        return
    import torch
    from rayfed_tpu_torch.fl import compression, streaming

    real = streaming.streaming_aggregate

    def broken(*args, **kwargs):
        agg = real(*args, **kwargs)
        if variant == "fault.altered":
            buf = agg.buf.clone()
            buf.view(-1)[0] += 1.0
        else:  # each party keeps its own contribution
            buf = kind.LOCAL[party].last_out.buf.clone()
        return compression.PackedTree(buf.to(torch.bfloat16), agg.passthrough, agg.spec)

    streaming.streaming_aggregate = broken


def _run(party: str, job: dict) -> dict:
    import torch

    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch import fl, telemetry
    from rayfed_tpu_torch.runtime import get_runtime

    from fedbench import devtrace, spec

    wl = job["workload"]
    kind = spec.kind_module("party", job["config"]["kind"])
    device = torch.device(job["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.set_num_threads(job["threads"])
    fed.init(
        address="local", cluster=job["cluster"], party=party, device=device, logging_level="warning",
        cross_silo_messages_max_size_in_bytes=4 << 30, enable_waiting_for_other_parties_ready=True,
        cross_silo_retry_policy={"maxAttempts": 30, "initialBackoff": "0.2s", "maxBackoff": "1s"},
    )
    _plant(job, party, kind)
    parties, coord = wl["parties"], wl["coordinator"]
    trainers = {p: fed.remote(kind.Trainer).party(p).remote(job, i) for i, p in enumerate(parties)}
    params = kind.initial(job, device)
    decide = fed.remote(_decide)
    tm = get_runtime().transport
    warm, traced = wl["warmup_rounds"], wl["traced_rounds"]
    marks: dict = {}
    prof: dict = {}

    def on_round(r, current):
        verdict = fed.get(decide.party(coord).remote(r, warm, job["seconds"]))
        marks[r] = (time.time(), tm.get_stats()["send_payload_bytes"])
        if job["trace"] and r == warm - 2:
            prof["run"] = devtrace.start(device)
        if "run" in prof and "stop_round" not in prof and (r == warm - 1 + traced or verdict == "stop"):
            prof["stop_round"] = r
            prof["run"][0].stop()
        if verdict == "stop":
            raise _Closed(current)

    timings: list = []
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    try:
        fl.run_fedavg_rounds(trainers, params, rounds=MAX_ROUNDS, coordinator=coord, on_round=on_round,
                             timings=timings, **wl["round_options"])
        raise RuntimeError(f"{MAX_ROUNDS} rounds and the window never closed")
    except _Closed as closed:
        current = closed.current
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    trainer = kind.LOCAL[party]
    held = {"upload": trainer.last_out.buf.cpu(), "final": fl.pack_tree(current, torch.bfloat16).buf.cpu()}
    if "grad1_diff" in wl["limits"]:
        held["grad1"] = {k: v.cpu() for k, v in trainer.grad1().items()}
    torch.save(held, os.path.join(job["tmp"], f"{party}.agg.pt"))
    recorder = telemetry.installed()
    report = {
        "party": party,
        "peak_bytes": peak,
        "marks": marks,
        "window": dict(WINDOW),
        "timings": timings if party == coord else None,
        "follow": trainer.follow_report(),
        "steps": trainer.k,
        "elems": trainer.last_out.buf.numel(),
        "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "spans": [telemetry.record_to_list(r) for r in recorder.records()] + trainer.spans
        if recorder is not None else None,
        "traced_stop_round": prof.get("stop_round"),
    }
    fed.shutdown()
    # Read the trace once the federation is down: its export holds this
    # process for seconds, and a peer waiting on it would declare it dead.
    report["kernels"] = devtrace.read(prof["run"], os.path.join(job["tmp"], f"{party}.trace.json")) \
        if "run" in prof else None
    report["forbidden"] = forbidden_modules()
    return report
