#!/usr/bin/env python3
"""One run of one cell of the benchmark of rayfed_tpu_torch.

    python3 fedbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Spawns the cell's party processes (``fedbench/party``), which build their
model from the seed on the card, warm up with whole rounds and then run
whole rounds of ``rayfed_tpu_torch.fl.run_fedavg_rounds`` until ``--seconds``
have passed.  Then the plain reference follows the first local steps of
every party and the fold of the last round, here, on the card, and the run
prints its checks on standard error and one JSON line on standard output:
the end-to-end metrics with ``--trace 0``, the per-layer metrics with
``--trace 1`` (``torch.profiler`` and the flight recorder on in every
party).  Exits 2 without a card, 1 when a party fails; prints no result
then.  This process imports nothing of the program.
"""

from __future__ import annotations

import argparse
import json
import math
import multiprocessing as mp
import os
import queue
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

T_CMD0 = time.time()
ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0] or ".").resolve() == Path(__file__).resolve().parent:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from fedbench import devtrace, judge, party, spec  # noqa: E402

VARIANTS = ("program", "control", "control.int8", "fault.state_unchanged", "fault.half_batch", "fault.no_exchange",
            "fault.altered")
FOLLOWED = ("loss_gap", "grad1_gap", "change_gap", "grad1_diff")
PARTY_TIMEOUT_S = 1100


def log(msg: str) -> None:
    print(f"[fedbench] {msg}", file=sys.stderr, flush=True)


def free_ports(n: int) -> list:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def child_env(trace: bool, threads: int) -> None:
    """What the party processes inherit: the flight recorder on or off and
    the host's cores shared out among them.  The port builds its kernels
    into ``rayfed_tpu_torch/_build/`` inside the checkout."""
    if trace:
        os.environ["RAYFED_TRACE"] = "1"
    else:
        os.environ.pop("RAYFED_TRACE", None)
    os.environ["USE_FLAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = str(threads)



def spawn(job: dict) -> dict:
    """Run every party; their reports by party, or raise."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    parties = job["workload"]["parties"]
    procs = {p: ctx.Process(target=party.party_main, name=f"party-{p}", args=(p, job, out)) for p in parties}
    for proc in procs.values():
        proc.start()
    reports: dict = {}
    deadline = time.monotonic() + PARTY_TIMEOUT_S
    try:
        while len(reports) < len(procs):
            if time.monotonic() > deadline:
                raise TimeoutError(f"no report in {PARTY_TIMEOUT_S} s from {sorted(set(procs) - set(reports))}")
            try:
                r = out.get(timeout=2)
            except queue.Empty:
                gone = [p for p, pr in procs.items() if p not in reports and not pr.is_alive()]
                if gone:
                    raise RuntimeError(f"party {gone} exited {[procs[p].exitcode for p in gone]} without a report")
                continue
            reports[r["party"]] = r
            if "error" in r:
                raise RuntimeError(f"party {r['party']} failed:\n{r['error']}")
        for proc in procs.values():
            proc.join(60)
    finally:
        for proc in procs.values():
            if proc.is_alive():
                proc.kill()
            proc.join(10)
    return reports


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def metric_context(job: dict, reports: dict, platform: str) -> dict:
    wl = job["workload"]
    coord = reports[wl["coordinator"]]
    w = coord["window"]
    window = {"t0": w["t0"], "t1": w["t1"], "r0": w["r0"], "r1": w["r1"], "rounds": w["r1"] - w["r0"]}
    ctx = {"job": job, "workload": wl, "config": job["config"], "platform": platform, "reports": reports,
           "device_name": coord["device_name"], "coordinator": wl["coordinator"], "t_cmd0": job["t_cmd0"],
           "window": window, "traced": None, "kernels": None, "spans": [], "timings": []}
    stop = coord["traced_stop_round"]
    if job["trace"] and stop is not None:
        marks = coord["marks"]
        tr = {"t0": marks[w["r0"]][0], "t1": marks[stop][0], "rounds": stop - w["r0"]}
        ctx["traced"] = tr
        ctx["timings"] = [t for t in coord["timings"] if w["r0"] < t["round"] <= stop]
        ctx["spans"] = [s for r in reports.values() for s in (r["spans"] or [])]
        if all(r["kernels"] is not None for r in reports.values()):
            ctx["kernels"] = [[p, *k] for p, r in reports.items() for k in devtrace.in_window(r["kernels"], tr["t0"],
                                                                                                tr["t1"])]
    return ctx


def breakdown(ctx: dict) -> dict:
    """The device operations that took most time (their attributed shares,
    ``devtrace.attributed``), and the longest idle gaps labelled with the
    host span (flight recorder or trainer) around them."""
    tr, ks = ctx["traced"], ctx["kernels"]
    by_name: dict = {}
    for (_p, name, _s, _d), share in zip(ks, devtrace.attributed(ks)):
        key = devtrace.short_name(name)
        by_name[key] = by_name.get(key, 0.0) + share
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    busy = devtrace.union(((s, s + d) for _p, _n, s, d in ks), tr["t0"], tr["t1"])
    spans = [(s[7], s[7] + s[8], f"{s[3]}@{s[0]}") for s in ctx["spans"]]
    labelled = []
    for a, b in sorted(devtrace.gaps(busy, tr["t0"], tr["t1"]), key=lambda g: g[0] - g[1])[:10]:
        mid = (a + b) / 2
        around = [sp for sp in spans if sp[0] <= mid <= sp[1]]
        label = min(around, key=lambda sp: sp[1] - sp[0])[2] if around else "host"
        labelled.append([label, b - a])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": labelled}


def check(job: dict, reports: dict, device: str) -> tuple:
    """``(correct, checks)``: the reference against what the timed path
    made, for the numbers that the cell's ``limits`` name.  Where the kind's
    reference has a ``control``, the control variant puts that in the
    program's place: its readings are judged instead of the program's."""
    wl, tmp, limits = job["workload"], job["tmp"], job["workload"]["limits"]
    import torch

    held = {p: torch.load(os.path.join(tmp, f"{p}.agg.pt")) for p in wl["parties"]}
    values = {}
    if "agg_mismatch" in limits:
        fold = spec.kind_module("reference", wl["fold"]).fold
        values["agg_mismatch"] = judge.fold_mismatch([held[p]["upload"] for p in wl["parties"]],
                                                     [held[p]["final"] for p in wl["parties"]], fold)
    if set(FOLLOWED) & set(limits):
        reference = spec.kind_module("reference", job["config"]["kind"])
        t0 = time.perf_counter()
        ref = reference.follow(job, torch.device(device))
        log(f"reference: {time.perf_counter() - t0:.1f} s")
        prog = {p: reports[p]["follow"] for p in wl["parties"]}
        grad1 = {p: held[p].get("grad1") for p in wl["parties"]}
        if job["variant"] == "control" and hasattr(reference, "control"):
            t0 = time.perf_counter()
            prog = reference.control(job, torch.device(device))
            grad1 = {p: prog[p]["grad1_tensors"] for p in wl["parties"]}
            log(f"control in the program's place: {time.perf_counter() - t0:.1f} s")
        values.update(judge.follow_gaps(prog, ref))
        if "grad1_diff" in limits:
            values["grad1_diff"] = judge.grad1_diff(grad1, ref)
    return judge.verdict(values, limits)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--variant", choices=VARIANTS, default="program", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None, *, device=None, overrides=None) -> int:
    args = parse(argv)
    wl, config = spec.cell(args.workload)
    for key, part in (overrides or {}).items():
        {"workload": wl, "config": config}[key].update(part)
    platform = "cpu" if device == "cpu" else "gpu"
    if device is None:
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
            log(f"needs {wl['chips']} CUDA card(s); found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        device = "cuda:0"
    threads = max(1, (os.cpu_count() or 1) // len(wl["parties"]))
    child_env(bool(args.trace), threads)
    tmp = tempfile.mkdtemp(prefix="fedbench-")
    job = {"workload": wl, "config": config, "seed": args.seed, "seconds": args.seconds, "trace": bool(args.trace),
           "variant": args.variant, "device": device, "tmp": tmp, "t_cmd0": T_CMD0, "threads": threads,
           "cluster": {p: {"address": f"127.0.0.1:{port}"}
                       for p, port in zip(wl["parties"], free_ports(len(wl["parties"])))}}
    try:
        try:
            reports = spawn(job)
        except Exception:
            log(traceback.format_exc())
            return 1
        seen = sorted({m for r in reports.values() for m in r["forbidden"]})
        if seen:
            log(f"a party process loaded {seen}")
            return 1
        ctx = metric_context(job, reports, platform)
        w = ctx["window"]
        log(f"window: {w['rounds']} rounds in {w['t1'] - w['t0']:.3f} s after {w['t0'] - T_CMD0:.1f} s of set-up")
        marks = reports[wl["coordinator"]]["marks"]
        log("round walls: " + " ".join(f"{marks[r][0] - marks[r - 1][0]:.3f}" for r in sorted(marks) if r - 1 in marks))
        metrics = {}
        for name, reader in spec.metrics().items():
            if reader.TRACE == args.trace and getattr(reader, "KIND", config["kind"]) == config["kind"]:
                value = reader.read(ctx)
                if value is not None:
                    metrics[name] = {"value": value, "unit": reader.UNIT}
        dev = {"platform": platform, "kind": ctx["device_name"], "count": wl["chips"],
               "memory_peak_bytes": sum(r["peak_bytes"] for r in reports.values())}
        if platform == "gpu":
            dev["power_limit"] = power_limit()
            log(f"card and power limit: {dev['power_limit']}")
        result = {"correct": False, "attempted": ctx["window"]["rounds"], "failed": 0, "metrics": metrics,
                  "device": dev}
        if args.trace and platform == "gpu" and ctx["kernels"] is not None:
            busy = devtrace.union(((s, s + d) for _p, _n, s, d in ctx["kernels"]), ctx["traced"]["t0"],
                                  ctx["traced"]["t1"])
            dev["busy_s"] = sum(e - s for s, e in busy)
            dev["window_s"] = ctx["traced"]["t1"] - ctx["traced"]["t0"]
            result["breakdown"] = breakdown(ctx)
        correct, checks = check(job, reports, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    seen = party.forbidden_modules()
    if seen:
        log(f"this process loaded {seen}")
        return 1
    if not all(math.isfinite(m["value"]) for m in metrics.values()):
        log(f"a metric is not finite: {metrics}")
        return 1
    result["correct"] = correct
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result, allow_nan=True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
