"""Shared pieces of the ``tests/test_torch_bench_smoke_*.py`` files: each
runs some of ``bench_torch.py --smoke``'s legs on the CPU through
``bench_torch.run_leg`` (each leg in its own spawned processes, as the bench
runs it) and holds them to the gates of ``bench.py --smoke``.

Exact gates (fixed by sizes, seeds and the arithmetic) are held at their
thresholds.  Timed gates (ratios of walls) are held present and finite:
these files run beside other test workers on a few cores, where such ratios
are not stable; ``python3 bench_torch.py --smoke --device cpu`` holds them
at their thresholds on an idle host.  Where a value is fixed by sizes and
numpy draws, the JAX package's own leg (``bench.py``, run through its
``_one_child``/``_multi_party``) gives the value the port must equal.

The port's children run with two OpenMP threads each (``OMP_NUM_THREADS``,
read by torch at import): with torch's default of one per core in every
child, the legs' children beside the other test workers oversubscribed the
host (the codec file took 369 s in a whole run of six workers on 8 cores;
its compressed leg 167 s beside six busy loops, 62 s with two threads)."""

from __future__ import annotations

import contextlib
import functools
import math
import multiprocessing as mp
import os
import queue
import time

import pytest

import bench_torch


@contextlib.contextmanager
def _env(**values):
    """Set environment variables for the children started inside."""
    before = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


@functools.lru_cache(maxsize=None)
def port_leg(name: str) -> dict:
    """The port's leg ``name`` on the CPU, run once per test file."""
    with _env(OMP_NUM_THREADS="2"):
        return bench_torch.run_leg(name, "cpu")


def gate_params(legs):
    return [pytest.param(g, id=g.name) for g in bench_torch.GATES if g.leg in legs]


def check_gate(gate, extra: dict) -> None:
    """An exact gate at its threshold; a timed gate present and finite."""
    assert f"{gate.leg}_error" not in extra, extra[f"{gate.leg}_error"]
    if gate.kind == "exact":
        assert bench_torch.gate_passes(gate, extra) is True, (gate, extra.get(gate.key))
    else:
        value = extra.get(gate.key)
        assert isinstance(value, (int, float)) and math.isfinite(value), (gate, value)


def _ref_runs():
    import bench

    def one(fn, fill, timeout=420):
        def run():
            extra = {}
            fill(extra, bench._one_child(fn, ndev=1, timeout=timeout))
            return extra
        return run

    def ring():
        extra = {}
        bench._fill_ring_extra(extra, _ref_ring_parties(bench.RINGB_PARTIES, timeout=420))
        return extra

    # The compressed leg binds its own fixed ports (13140-13143, a local of
    # the leg): a concurrent ``bench.py --smoke`` on the host can collide.
    return {
        "compressed_agg": one("_run_compressed_agg_bench", bench._fill_compressed_extra),
        "server_opt": one("_run_server_opt_bench", bench._fill_server_opt_extra),
        "hierarchy": one("_run_hierarchy_bench", bench._fill_hierarchy_extra, timeout=600),
        "ring_agg": ring,
    }


def _ref_ring_party(party: str, result_q, cluster: dict) -> None:
    """Spawn-process entry: ``bench.py``'s own ring party on ``cluster``
    in place of its fixed ports (``RINGB_CLUSTER``, 13110-13113), which a
    concurrent ``bench.py --smoke`` on the host would hold."""
    import bench

    bench.RINGB_CLUSTER = cluster
    bench._party_child("_run_ring_agg_party", party, result_q, 1)


def _ref_ring_parties(parties, timeout: int) -> dict:
    """``bench._multi_party`` for the ring leg, on free loopback ports."""
    from rayfed_tpu_torch.utils.ports import free_loopback_ports

    cluster = {p: {"address": f"127.0.0.1:{port}"} for p, port in zip(parties, free_loopback_ports(len(parties)))}
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_ref_ring_party, args=(p, q, cluster)) for p in parties]
    for p in procs:
        p.start()
    results = {}
    deadline = time.time() + timeout
    try:
        while len(results) < len(parties) and time.time() < deadline:
            try:
                party, value = q.get(timeout=5)
                results[party] = value
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.terminate()
    assert len(results) == len(parties), f"reference ring leg failed; partial results: {results}"
    return results


@functools.lru_cache(maxsize=None)
def reference_leg(name: str) -> dict:
    """``bench.py``'s own leg ``name`` (the JAX package, on the CPU) at its
    smoke sizes, run once per test file."""
    with _env(RAYFED_BENCH_SMOKE="1"):
        return _ref_runs()[name]()
