"""Shared pieces of the ``tests/test_torch_bench_fed_*.py`` files: each runs
some of ``bench_torch.py --fed-only``'s legs on the CPU through
``bench_torch.run_fed`` at small sizes (``SMALL``, each leg's keyword
arguments; the widths the size-fixed keys depend on stay the reference's),
every leg in its own spawned processes as the bench runs it, and holds the
record to ``bench.py``'s federated section: every key it sets
(``KEYS``, read from ``bench.py:5535-5890``), no leg failed, no child
loaded JAX.  The children run with two OpenMP threads each, as the smoke
files' do (``tests/torch_bench_smoke.py``)."""

from __future__ import annotations

import functools
import math

import bench_torch
from tests.torch_bench_smoke import _env

# Each leg at a small size on the CPU: fewer rows, steps and rounds.  The
# LoRA leg keeps the reference's Llama, and the four full-size smoke legs
# their ResNet-18 bundles, so that their size-fixed keys are the
# reference's own.
SMALL = {
    "pp_bench": {"width": 32, "batch": 16, "n": 1, "reps": 1},
    "split_fl": {"n": 64, "d_hidden": 32, "steps": 2, "windows": 1},
    "push_bench": {"rows": 64, "cols": 1024, "steps": 2, "reshard_steps": 2, "reps": 1, "rail_steps": 1,
                   "rail_reps": 1, "leaves": 4, "leaf_rows": 2},
    "send_path": {"rounds": 1},
    "stream_agg": {"rounds": 1},
    "ring_agg": {"rounds": 1},
    "overlap": {"rounds": 2},
    "lora_2party": {"seq": 16, "batch": 2, "rounds": 1},
    "resnet_fedavg": {"batch": 2, "hw": 8, "rounds": 1},
    "resnet_dp": {"batch": 2, "hw": 8, "rounds": 1},
    "fedavg_mnist": {"n": 64, "d": 16, "warmup": 1, "rounds": 2},
}

# Every key bench.py's federated section sets, by leg (the 4-slice
# prediction's keys appear only when the fedavg/dp ratio is under 0.9).
KEYS = {
    "pp_bench": ("pp_step_ms", "pp_interleaved_step_ms", "dp_step_ms", "pp_vs_dp_step_ratio",
                 "pp_interleaved_vs_dp_step_ratio"),
    "split_fl": ("split_fl_GBps", "split_fl_steps_per_sec", "split_fl_bf16_steps_per_sec", "split_fl_wire_read_ms",
                 "split_fl_send_path_ms", "split_fl_other_ms", "split_fl_compute_probe_s"),
    "push_bench": ("push_GBps", "push_reshard_GBps", "multirail_GBps", "singlerail_GBps", "multirail_vs_single_rail",
                   "cross_party_packed_GBps", "cross_party_perleaf_GBps", "packed_codec_speedup",
                   "send_overlap_saved_frac", "split_fl_ceiling_steps_per_sec", "split_fl_vs_ceiling"),
    "send_path": ("coord_send_path_ms", "coord_wire_read_ms", "cross_party_wire_GBps", "local_link_GBps",
                  "local_link_backend", "local_link_uds_GBps", "local_link_vs_wire", "push_capability_GBps",
                  "send_path_breakdown_ms", "send_path_overhead_ratio", "send_path_striped_payloads",
                  "send_path_wire_GBps", "send_vs_read_wall_ratio", "wire_vs_push_capability"),
    "stream_agg": ("agg_overlap_frac", "cross_party_stream_agg_GBps", "delta_bytes_saved_frac", "stream_agg_bcast_ms",
                   "stream_agg_bundle_mb", "stream_agg_busy_ms", "stream_agg_contrib_ms", "stream_agg_round_ms",
                   "stream_agg_tail_ms", "stream_agg_wire_ms"),
    "ring_agg": ("coord_bytes_in_frac", "coord_bytes_in_frac_hub", "hub_round_ms", "ring_agg_GBps", "ring_bundle_mb",
                 "ring_coord_ingress_vs_hub", "ring_f32cold_round_ms", "ring_quant_bytes_frac",
                 "ring_quant_round_ms", "ring_round_ms", "ring_vs_coord_speedup"),
    "overlap": ("overlap_comms_ms_per_round", "overlap_hidden_comm_frac", "overlap_local_ms_per_round",
                "overlap_round_ms", "round_wall_speedup", "sync_round_ms"),
    "lora_2party": ("lora_2party_rounds_per_sec", "lora_adapter_MB_per_push"),
    "resnet_fedavg": ("resnet_4party_rounds_per_sec", "cross_party_goodput_GBps", "resnet_coord_wire_read_ms",
                      "resnet_coord_send_path_ms", "cross_party_GBps", "cross_party_wire_GBps",
                      "resnet_coord_send_vs_read_ratio", "resnet_round_step_ms", "resnet_round_cpu_s_total",
                      "resnet_round_busy_frac", "resnet_round_step_wall_frac", "resnet_decomp_ms",
                      "resnet_decomp_perleaf_ms", "resnet_decomp_speedup", "resnet_decomp_step_frac",
                      "resnet_compute_floor_rounds_per_sec", "resnet_floor_cpu_s_total",
                      "resnet_fedavg_overhead_ratio"),
    "resnet_dp": ("resnet_dp_control_rounds_per_sec", "resnet_dp_cpu_s", "resnet_fedavg_vs_dp_ratio",
                  "resnet_batch_efficiency_ratio", "resnet_vs_dp_method"),
    "fedavg_mnist": ("metric", "value", "unit", "vs_baseline"),
}
PRED_KEYS = ("resnet_pred_compute_floor_s", "resnet_pred_wire_s", "resnet_pred_overlap_frac",
             "resnet_pred_4slice_ratio", "resnet_pred_4slice_ratio_full_overlap")
ENV_KEYS = ("env_cpu_count", "env_loadavg_1m", "env_platform", "env_device_kind")


@functools.lru_cache(maxsize=None)
def port_run(legs: tuple, lanes: int = 1) -> tuple:
    """The port's federated section over ``legs`` on the CPU, ``lanes`` legs
    at a time, once per test file: ``(record, stats)``."""
    stats: dict = {}
    with _env(OMP_NUM_THREADS="2"):
        record = bench_torch.run_fed("cpu", stats=stats, legs=legs, leg_kw=SMALL, settle_s=0.0, lanes=lanes)
    return record, stats


def check_leg_keys(record: dict, leg: str) -> None:
    """The leg ran without error and set every key bench.py sets for it,
    each a finite number where it is one."""
    assert f"{leg}_error" not in record, record[f"{leg}_error"]
    for key in KEYS[leg]:
        assert key in record, key
        value = record[key]
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            assert math.isfinite(value), (key, value)
