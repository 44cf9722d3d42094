"""``bench_torch.py --smoke`` on the CPU, part 1: the legs of in-process
transport managers (stream_agg, send_path, object_plane, telemetry), the
command line and the gate table.  See ``tests/torch_bench_smoke.py``."""

import json
import math
import os
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import pytest

import bench_torch
from tests.torch_bench_smoke import check_gate, gate_params, port_leg

ROOT = Path(__file__).resolve().parents[1]
LEGS = ("stream_agg", "send_path", "object_plane", "telemetry")


@pytest.mark.parametrize("gate", gate_params(LEGS))
def test_gate(gate):
    check_gate(gate, port_leg(gate.leg))


def test_stream_agg_leg_reports_its_round():
    extra = port_leg("stream_agg")
    assert "stream_agg_error" not in extra, extra.get("stream_agg_error")
    for key in ("cross_party_stream_agg_GBps", "agg_overlap_frac", "stream_agg_round_ms", "stream_agg_busy_ms"):
        assert math.isfinite(extra[key]) and extra[key] >= 0, key
    # Each round rewrites one quarter: the delta cache keeps some of the
    # stream off the wire, never all of it.
    assert 0 < extra["delta_bytes_saved_frac"] < 1
    assert extra["stream_agg_bundle_mb"] == 12.0  # 4 x 1.5M elements in bf16


def test_send_path_local_link_legs():
    extra = port_leg("send_path")
    assert extra["local_link_backend"] == "shm"
    assert extra["send_path_striped_payloads"] >= 0
    assert set(extra["send_path_breakdown_ms"]) >= {"encode_ms", "crc_ms", "socket_ms"}
    assert extra["local_link_uds_GBps"] > 0


def test_object_plane_warm_rejoin_moves_only_a_handle():
    extra = port_leg("object_plane")
    # The eager welcome carries the 4 MiB f32 model, the warm one a handle.
    assert extra["eager_welcome_bytes"] > 4 * 2**20
    assert extra["warm_welcome_bytes"] < 4096


def test_telemetry_merges_every_party():
    extra = port_leg("telemetry")
    assert extra["trace_merged_records"] > 0
    assert extra["trace_dropped"] == 0


def _no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run every leg on it")


def test_smoke_without_a_card_fails_before_any_leg():
    _no_card()
    proc = subprocess.run([sys.executable, "bench_torch.py", "--smoke"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "smoke (" not in proc.stderr  # no leg started
    assert proc.stdout.strip() == ""  # no record


def test_without_smoke_exits_2():
    """Without ``--smoke`` (no mode flag) the bench runs ``bench.py``'s
    federated and compute sections, which exited 2 before they were ported;
    without a card it fails before any leg and prints no record."""
    _no_card()
    proc = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not any(f"{msg} on" in proc.stderr for _, msg, _ in bench_torch.FED_LEGS)  # no leg started
    assert proc.stdout.strip() == ""


def test_run_smoke_raises_without_a_card():
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.run_smoke("cuda")


def test_gate_table_covers_the_reference_gates():
    keys = {g.key for g in bench_torch.GATES}
    assert keys >= {
        "coord_bytes_in_frac", "overlap_hidden_comm_frac", "wire_vs_push_capability", "send_vs_read_wall_ratio",
        "local_link_vs_wire", "local_link_backend", "compressed_bytes_on_wire_frac", "compressed_fold_speedup",
        "compressed_agg_bitexact", "compressed_loss_ratio", "secagg_bitexact", "secagg_overhead_frac",
        "fedac_rounds_to_target_frac", "server_opt_agg_bitexact", "rejoin_welcome_bytes_frac",
        "blob_dedup_single_transfer", "blob_handle_state_identical", "hier_bitexact", "hier_party_bytes_frac_4",
        "hier_party_bytes_frac_16", "hier_party_bytes_frac_64", "hier_party_bytes_frac_256",
        "hier_ingress_flatness", "hier_round_ratio_64_over_16", "hier_round_ratio_256_over_64",
        "hier_root_egress_frac_256", "hier_chaos_fallbacks", "hier_chaos_agree", "hier_chaos_cutoffs",
        "chaos_rounds_completed", "chaos_survivors", "chaos_final_consistent", "chaos_round1_members",
        "chaos_roster_epoch", "chaos_coordinator_failovers", "trace_overhead_frac", "trace_critical_path_agrees",
        "async_tt_frac", "async_refold_bitexact", "async_versions_per_sec",
    }
    assert {g.leg for g in bench_torch.GATES} <= set(bench_torch.LEG_NAMES)
    assert {g.kind for g in bench_torch.GATES} == {"exact", "timed"}
    assert len({g.name for g in bench_torch.GATES}) == len(bench_torch.GATES)
    assert len(bench_torch.LEG_NAMES) == 12


@pytest.mark.parametrize("key, value, verdict", [
    ("coord_bytes_in_frac", 0.4, True), ("coord_bytes_in_frac", 0.41, False), ("coord_bytes_in_frac", None, False),
    ("overlap_hidden_comm_frac", 0.5, True), ("overlap_hidden_comm_frac", 0.49, False),
    ("secagg_bitexact", True, True), ("secagg_bitexact", False, False), ("secagg_bitexact", None, False),
    ("local_link_backend", "shm", True), ("local_link_backend", "uds", False),
    ("chaos_round1_members", ["alice", "bob"], True), ("chaos_round1_members", ["alice"], False),
    ("chaos_round1_members", ["alice", "bob", "carol", "dave"], False),
    ("hier_chaos_agree", True, True), ("hier_chaos_agree", 1, False),
    ("hier_chaos_fallbacks", 0, True), ("hier_chaos_fallbacks", None, False),
])
def test_gate_verdicts(key, value, verdict):
    gate = next(g for g in bench_torch.GATES if g.key == key)
    extra = {key: value, "hier_round_ratio_256_over_64": 1.0}
    assert bench_torch.gate_passes(gate, extra) is verdict


def test_n256_gates_skip_only_when_the_leg_did_not_run():
    n256 = [g for g in bench_torch.GATES if g.requires is not None]
    assert {g.key for g in n256} >= {"hier_party_bytes_frac_256", "hier_round_ratio_256_over_64"}
    assert all(bench_torch.gate_passes(g, {"hier_n256_skipped": "fd"}) is None for g in n256)
    failed = bench_torch.failed_gates({"hier_n256_skipped": "fd", "hierarchy_error": "x"}, ("hierarchy",))
    assert "hierarchy_error" in failed and not set(failed) & {g.name for g in n256}


def test_a_child_that_loaded_jax_cannot_report(monkeypatch):
    """Every leg's children report through this queue: a report from a
    process that loaded JAX or the JAX package raises instead."""
    sent = []
    q = bench_torch._NoJaxQueue(type("Q", (), {"put": lambda self, item: sent.append(item)})())
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(AssertionError, match="jax"):
        q.put(("solo", {}))
    assert sent == []


def test_run_smoke_returns_the_record_and_its_failed_gates():
    stats = {}
    record, failed = bench_torch.run_smoke("cpu", legs=("object_plane",), stats=stats)
    assert failed == []
    assert {k: record[k] for k in ("metric", "unit", "vs_baseline", "smoke")} == {
        "metric": "cross_party_stream_agg_GBps", "unit": "GB/s", "vs_baseline": 1.0, "smoke": True}
    assert json.loads(json.dumps(record)) == record
    # The children report their kernel launches: none on the CPU.
    assert stats["object_plane"]["launches"] == {"fold_fma": 0, "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                                                 "rms_norm_fwd": 0, "rms_norm_bwd": 0, "rms_norm_dscale": 0}
    assert stats["object_plane"]["s"] > 0


def test_run_smoke_lanes_run_legs_at_once_and_merge_in_order(monkeypatch):
    """Two lanes run two legs at once (each waits at a barrier for the
    other), each under the smoke flag until both have ended, and the record
    merges their keys in the legs' order as one lane does."""
    barrier = threading.Barrier(2, timeout=30)
    seen = {}

    def leg(name, wait):
        def runner(device, extra, launches):
            if wait:
                barrier.wait()
            time.sleep(0.2 if name == "a" else 0.0)  # "b" ends first: its flag must outlive it
            seen[name] = os.environ.get("RAYFED_BENCH_SMOKE")
            extra[f"{name}_key"] = 1
            extra["shared"] = name
        return (name, f"leg {name}", runner)

    monkeypatch.delenv("RAYFED_BENCH_SMOKE", raising=False)
    monkeypatch.setattr(bench_torch, "LEGS", (leg("a", True), leg("b", True), leg("c", False)))
    stats = {}
    record, failed = bench_torch.run_smoke("cpu", legs=("a", "b", "c"), stats=stats, lanes=2)
    assert failed == [] and seen == {"a": "1", "b": "1", "c": "1"}
    assert record["shared"] == "c" and list(record)[-4:] == ["a_key", "shared", "b_key", "c_key"]
    assert set(stats) == {"a", "b", "c"} and "RAYFED_BENCH_SMOKE" not in os.environ
    monkeypatch.setattr(bench_torch, "LEGS", (leg("a", False), leg("b", False), leg("c", False)))
    assert bench_torch.run_smoke("cpu", legs=("a", "b", "c"))[0] == record


def test_chip_smoke_rerun_in_a_spawned_child_stays_light():
    """chip_smoke.py calls the legs in-process, so spawn re-runs it as
    ``__mp_main__`` in every bench child: that run loads no DTensor or
    sympy and does not touch the card."""
    code = ("import runpy, sys, torch; runpy.run_path('chip_smoke.py', run_name='__mp_main__'); "
            "heavy = [m for m in ('sympy', 'torch.distributed.tensor', 'torch._dynamo') if m in sys.modules]; "
            "assert not heavy and not torch.cuda.is_initialized(), heavy")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
