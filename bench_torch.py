"""Bench harness of the PyTorch package: ``bench.py``'s ``--smoke`` mode and
its compute section on ``rayfed_tpu_torch``.

``python3 bench_torch.py --smoke`` runs the twelve smoke legs of
``bench.py --smoke`` on the port, on the CUDA card (``--device cpu`` runs
them on the host), prints ONE JSON line with the reference's keys and
exits 1 when a leg fails or a gate misses, with every threshold of the
reference unchanged.  ``python3 bench_torch.py --compute-only`` runs
``bench.py --compute-only``'s five legs in this process on the card
(``--device cpu`` on the host): the ~1.07B Llama's Adam step with its MFU
breakdown, its KV-cache decode, flash against dense attention, Llama-3-8B's
int8-base LoRA step and int8 decode, and MoE dispatch; it prints ONE JSON
line with the reference's keys and exits 1 when a leg fails.
``python3 bench_torch.py --fed-only`` runs ``bench.py``'s federated section
on the port, on the card (``--device cpu`` on the host): the pipeline
against DP over a 4-rank world, split learning's activation push, the raw
push path, the full-size send-path, streaming, ring and overlap legs, the
2-party Llama-LoRA fine-tune, 4-party ResNet-18 FedAvg with its floor and
DP control, and the headline 2-party FedAvg
(``fedavg_mnist_2party_rounds_per_sec``); it prints ONE JSON line with the
reference's keys and exits 1 when a leg fails.  With no mode flag it runs
the federated section, then the compute section, and prints one line, as
``bench.py`` does.

Each smoke leg keeps the reference's function name, its ``_fill_*_extra``,
its result keys, its smoke sizes (``RAYFED_BENCH_SMOKE``) and its shape of
processes: ``_one_child`` runs a leg in one spawned process of in-process
virtual parties, ``_multi_party`` runs one spawned process per party.
Every child gets the party's ``device`` and asserts, when it reports, that
it loaded neither JAX nor the JAX package.  Listeners take free loopback
ports.  Draws the reference makes with numpy are the same numbers here;
draws it makes with ``jax.random`` come from seeded ``torch.Generator``\\s
of the same shapes.  Each compute leg keeps the reference's name, sizes,
repetition counts (keyword arguments, the reference's by default) and
slope timing, with every timed run ending in a read of its result; the
shares (``llama_mfu``, ``*_membw_util``) are the port's own work over the
card's data-sheet peaks (``_PEAK_FLOPS``, ``_PEAK_HBM_BPS``).

``run_smoke(device)`` runs every smoke leg in this process's control and
returns ``(record, failed_gates)``; ``run_leg(name, device)`` runs one leg
and returns its keys.  ``GATES`` is the gate table: each gate is ``exact``
(fixed by sizes, seeds and the arithmetic) or ``timed`` (a ratio of walls).
``run_compute(device)`` runs the compute legs and returns the record;
``run_fed(device)`` runs the federated legs (each leg's sizes and counts
keyword arguments, the reference's by default) and returns the record.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import math
import multiprocessing as mp
import os
import sys
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

# Modules a bench child must never load.
_FOREIGN = ("jax", "jaxlib", "rayfed_tpu")


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(device) -> None:
    """Wait for the card's queued work (a timed window must hold it)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _np(x) -> np.ndarray:
    """A buffer (tensor on any device, or array) as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _raw_bytes(x) -> bytes:
    """A buffer's bytes on the host, whatever its dtype."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def _managers(parties, device, **job):
    """One started TransportManager per party on free loopback ports."""
    from rayfed_tpu_torch.config import ClusterConfig, JobConfig, PartyConfig
    from rayfed_tpu_torch.transport.manager import TransportManager
    from rayfed_tpu_torch.utils.ports import free_loopback_ports

    ports = dict(zip(parties, free_loopback_ports(len(parties))))
    mgrs = {}
    for party in parties:
        cc = ClusterConfig(
            parties={p: PartyConfig.from_dict({"address": f"127.0.0.1:{ports[p]}"}) for p in parties},
            current_party=party,
        )
        mgrs[party] = TransportManager(cc, JobConfig(**job), device=device)
    for m in mgrs.values():
        m.start()
    return mgrs


def _cluster(parties) -> dict:
    """A fed.init cluster of the parties on free loopback ports."""
    from rayfed_tpu_torch.utils.ports import free_loopback_ports

    return {p: {"address": f"127.0.0.1:{port}"} for p, port in zip(parties, free_loopback_ports(len(parties)))}


# --------------------------------------------------------------------------
# The smoke legs (each runs in a spawned child; see _one_child/_multi_party)
# --------------------------------------------------------------------------

def _smoke_tree(device):
    """The smoke legs' shared synthetic tree (~12 MB bf16 = 3 delta
    chunks), on ``device``: the stream-agg, ring, compressed and telemetry
    legs aggregate the identical payload shape."""
    return {
        f"l{i}": torch.arange(1_500_000, dtype=torch.float32, device=device) * 1e-6 + i
        for i in range(4)
    }


def _rotating_quarter(bundle):
    """``contribution(party_idx, r)`` of the stream-agg, ring and telemetry
    legs: quarter ``r % 4`` of the bundle perturbed, party-specific, the
    rest byte-stable (the shape where the delta cache pays)."""
    from rayfed_tpu_torch.fl import compression as fl_comp

    base32 = bundle.buf.to(torch.float32)
    n_elems = base32.numel()
    wire_dt = bundle.buf.dtype

    def contribution(party_idx: int, r: int):
        arr = base32.clone()
        q = n_elems // 4
        lo = (r % 4) * q
        arr[lo: lo + q] += 1e-3 * (party_idx + 1) * (r + 1)
        return fl_comp.PackedTree(arr.to(wire_dt), bundle.passthrough, bundle.spec)

    return base32, contribution


def _run_stream_agg_bench(_party: str, result_q, device, kw: Optional[dict] = None) -> None:
    """Streaming FedAvg round with the delta cache (bench.py's leg): three
    peers push packed bf16 bundles on per-peer delta streams to alice,
    whose ``StreamingAggregator`` folds each chunk on ``device`` as it
    arrives (``fold_fma`` on the card), then broadcasts the aggregate on a
    delta stream.  Each round updates one rotating quarter."""
    from rayfed_tpu_torch.fl import compression as fl_comp
    from rayfed_tpu_torch.fl.streaming import StreamingAggregator

    smoke = bool(os.environ.get("RAYFED_BENCH_SMOKE"))
    parties = ("alice", "bob", "carol", "dave")
    mgrs = _managers(parties, device, device_put_received=False, zero_copy_host_arrays=True)

    if smoke:
        bundle = fl_comp.compress(_smoke_tree(device), packed=True)
        rounds = 2
    else:
        from rayfed_tpu_torch.models import resnet

        cfg = resnet.resnet18(num_classes=10)
        bundle = fl_comp.compress(
            resnet.init_resnet(torch.Generator().manual_seed(0), cfg, device=device), packed=True
        )
        rounds = _kw(kw, "rounds", 3)

    bundle_bytes = bundle.buf.numel() * bundle.buf.element_size()
    _, contribution = _rotating_quarter(bundle)
    peers = [p for p in parties if p != "alice"]

    def do_round(r: int):
        t0 = time.perf_counter()
        contribs = {p: contribution(i + 1, r) for i, p in enumerate(peers)}
        send_refs = [
            mgrs[p].send("alice", contribs[p], f"c{r}-{p}", "0", stream=f"sagg/up/{p}")
            for p in peers
        ]
        agg = StreamingAggregator(len(parties), device=device)
        for i, p in enumerate(peers):
            mgrs["alice"].recv_stream(p, f"c{r}-{p}", "0", agg.sink(i + 1))
        agg.add_local(0, contribution(0, r))
        result = agg.result(timeout=300)
        t_agg = time.perf_counter()
        bcast_refs = mgrs["alice"].send_many(peers, result, f"b{r}", "0", stream="sagg/down")
        for p in peers:
            out = mgrs[p].recv("alice", f"b{r}", "0").resolve(timeout=300)
            out.buf[:64].cpu()  # touch: decode really happened
        for ref in send_refs + list(bcast_refs.values()):
            if not ref.resolve(timeout=300):
                raise RuntimeError("stream agg bench send failed")
        t_end = time.perf_counter()
        return t0, t_agg, t_end, dict(agg.stats)

    do_round(0)  # warmup: seeds every delta cache

    def delta_totals():
        logical = wire_b = 0
        for m in mgrs.values():
            st = m.get_stats()
            logical += st["delta_logical_bytes"]
            wire_b += st["delta_wire_bytes"]
        return logical, wire_b

    logical0, wire0 = delta_totals()
    agg_s = bcast_s = wall_s = 0.0
    overlaps, busys, tails, wires = [], [], [], []
    for r in range(1, rounds + 1):
        t0, t_agg, t_end, stats = do_round(r)
        agg_s += t_agg - t0
        bcast_s += t_end - t_agg
        wall_s += t_end - t0
        overlaps.append(stats["agg_overlap_frac"])
        busys.append(stats["agg_busy_s"])
        tails.append(stats["agg_tail_s"])
        wires.append(stats["agg_wire_s"])
    logical1, wire1 = delta_totals()
    for m in mgrs.values():
        m.stop()

    contrib_bytes = len(peers) * bundle_bytes
    logical = logical1 - logical0
    shipped = wire1 - wire0
    result_q.put((
        "stream",
        {
            "gbps": contrib_bytes * rounds / agg_s / 1e9,
            "overlap": sum(overlaps) / len(overlaps),
            "delta_saved": (logical - shipped) / logical if logical else 0.0,
            "round_ms": wall_s / rounds * 1e3,
            "contrib_agg_ms": agg_s / rounds * 1e3,
            "bcast_ms": bcast_s / rounds * 1e3,
            "agg_busy_ms": sum(busys) / rounds * 1e3,
            "agg_tail_ms": sum(tails) / rounds * 1e3,
            "agg_wire_ms": sum(wires) / rounds * 1e3,
            "bundle_mb": bundle_bytes / 1e6,
        },
    ))


def _run_compressed_agg_bench(_party: str, result_q, device) -> None:
    """Shared-grid uint8 aggregation against the bf16 path (bench.py's
    leg): (1) bytes on the wire over R fresh rounds each way, (2) the i32
    fold of the codes against dequantize-first (the f32 fold, ``fold_fma``
    on the card), the card synchronized inside each timed window, (3) the
    2-party quadratic with 8-bit + error feedback against exact f32, and
    the streamed integer fold byte-equal to ``packed_quantized_sum``."""
    from rayfed_tpu_torch.fl import compression as fl_comp
    from rayfed_tpu_torch.fl import fedavg as fl_fedavg
    from rayfed_tpu_torch.fl import quantize as qz
    from rayfed_tpu_torch.fl.streaming import StreamingAggregator, _fold_block

    parties = ("alice", "bob", "carol", "dave")
    mgrs = _managers(parties, device, device_put_received=False, zero_copy_host_arrays=True)

    bundle16 = fl_comp.compress(_smoke_tree(device), packed=True)  # bf16
    ref32 = bundle16.buf.to(torch.float32)
    n_elems = ref32.numel()
    rng = np.random.default_rng(0)
    prev_delta = (1e-3 * rng.standard_normal(n_elems)).astype(np.float32)
    grid = qz.make_round_grid(prev_delta, mode="delta", expand=4.0)
    peers = [p for p in parties if p != "alice"]
    rounds = 2

    def contribution32(party_idx: int, r: int) -> torch.Tensor:
        # Fully fresh each round (seeded noise everywhere): the delta cache
        # has nothing to skip, so this measures the codec.
        noise = np.random.default_rng(100 * r + party_idx)
        return ref32 + torch.from_numpy((1e-3 * noise.standard_normal(n_elems)).astype(np.float32)).to(device)

    def sent_bytes() -> int:
        return sum(m.get_stats()["send_bytes"] for m in mgrs.values())

    def tree_of(buf, dtype):
        return fl_comp.PackedTree(
            buf.to(dtype), bundle16.passthrough,
            fl_comp.PackSpec(bundle16.spec.entries, bundle16.spec.treedef, fl_comp.dtype_name(dtype)),
        )

    def do_round_bf16(r: int) -> float:
        t0 = time.perf_counter()
        send_refs = [
            mgrs[p].send("alice", tree_of(contribution32(i + 1, r), torch.bfloat16), f"b16-{r}-{p}", "0")
            for i, p in enumerate(peers)
        ]
        agg = StreamingAggregator(len(parties), device=device)
        for i, p in enumerate(peers):
            mgrs["alice"].recv_stream(p, f"b16-{r}-{p}", "0", agg.sink(i + 1))
        agg.add_local(0, tree_of(contribution32(0, r), torch.bfloat16))
        result = agg.result(timeout=300)
        bcast = mgrs["alice"].send_many(peers, result, f"b16b-{r}", "0")
        for p in peers:
            mgrs[p].recv("alice", f"b16b-{r}", "0").resolve(timeout=300)
        for ref in send_refs + list(bcast.values()):
            if not ref.resolve(timeout=300):
                raise RuntimeError("bf16 round send failed")
        return time.perf_counter() - t0

    bitexact = True

    def do_round_quant(r: int) -> float:
        nonlocal bitexact
        t0 = time.perf_counter()
        qts = [
            qz.quantize_packed(tree_of(contribution32(i, r), torch.float32), grid, ref=ref32)
            for i in range(len(parties))
        ]
        gd = qz.grid_descriptor(grid)
        send_refs = [
            mgrs[p].send("alice", qts[i + 1], f"q-{r}-{p}", "0", quant_meta=gd)
            for i, p in enumerate(peers)
        ]
        agg = StreamingAggregator(len(parties), quant=grid, quant_ref=ref32, device=device)
        for i, p in enumerate(peers):
            mgrs["alice"].recv_stream(p, f"q-{r}-{p}", "0", agg.sink(i + 1))
        agg.add_local(0, qts[0])
        result = agg.result(timeout=300)
        if r == 0:
            want = fl_fedavg.packed_quantized_sum(qts, ref=ref32)
            bitexact = bitexact and _raw_bytes(result.buf) == _raw_bytes(want.buf)
        # Quantized downlink: a fresh grid from the aggregate's delta,
        # carried in the payload.
        down = qz.make_round_grid(result.buf - ref32, mode="delta")
        wire_result = qz.quantize_packed(result, down, ref=ref32)
        bcast = mgrs["alice"].send_many(peers, wire_result, f"qb-{r}", "0", quant_meta=qz.grid_descriptor(down))
        for p in peers:
            got = mgrs[p].recv("alice", f"qb-{r}", "0").resolve(timeout=300)
            got.dequantize(torch.float32, ref=ref32)
        for ref in send_refs + list(bcast.values()):
            if not ref.resolve(timeout=300):
                raise RuntimeError("quant round send failed")
        return time.perf_counter() - t0

    do_round_bf16(99)  # warmup: both stacks
    do_round_quant(98)

    b0 = sent_bytes()
    bf16_s = sum(do_round_bf16(r) for r in range(rounds))
    bf16_bytes = sent_bytes() - b0
    b0 = sent_bytes()
    quant_s = sum(do_round_quant(r) for r in range(rounds))
    quant_bytes = sent_bytes() - b0
    for m in mgrs.values():
        m.stop()

    # --- fold throughput: integer fold vs dequantize-first ------------
    ce = fl_fedavg.DEFAULT_CHUNK_ELEMS
    nb = fl_fedavg.packed_block_grid(n_elems, ce)
    codes = [
        fl_fedavg.as_tensor(
            qz.quantize_packed(tree_of(contribution32(i, 0), torch.float32), grid, ref=ref32).buf, device
        )
        for i in range(len(parties))
    ]
    pad = nb * ce - n_elems
    padded = [torch.cat([c, c.new_zeros(pad)]) for c in codes]
    sc_rows = torch.from_numpy(grid.scales).to(device)
    zp_rows = torch.from_numpy(grid.zps).to(device)
    one = 1.0  # the fold's weight: a host number, passed to the kernel by value

    # Fold-only timing; 6 passes over every contribution per sample.
    fold_passes = 6

    def run_int() -> float:
        acc = torch.zeros(nb * ce, dtype=torch.int32, device=device)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(fold_passes):
            for c in padded:
                for b in range(nb):
                    fl_fedavg.quantized_accum_kernel(acc, b * ce, c[b * ce:(b + 1) * ce], 1)
        _sync(device)
        return time.perf_counter() - t0

    def run_dequant_first() -> float:
        acc = torch.zeros(nb * ce, dtype=torch.float32, device=device)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(fold_passes):
            for c in padded:
                for b in range(nb):
                    # The reference's dequantize kernel without a ref:
                    # scale·(q − zp), then the f32 fold of the chunk.
                    chunk = sc_rows[b] * (c[b * ce:(b + 1) * ce].to(torch.float32) - zp_rows[b])
                    _fold_block(acc, b * ce, chunk, one)
        _sync(device)
        return time.perf_counter() - t0

    run_int(), run_dequant_first()  # warmup
    # min-of-N on an alternating schedule: both paths see the same load.
    int_times, dq_times = [], []
    for _ in range(5):
        int_times.append(run_int())
        dq_times.append(run_dequant_first())
    int_s = min(int_times)
    dq_s = min(dq_times)

    # --- convergence: 8-bit+EF vs exact f32 on a quadratic -------------
    rng = np.random.default_rng(3)
    target = rng.normal(size=(1 << 16,)).astype(np.float32)
    shift = [0.3 * rng.normal(size=target.shape).astype(np.float32) for _ in range(2)]

    def conv(quantized: bool) -> float:
        x = np.zeros_like(target)
        comps = [qz.QuantCompressor() for _ in range(2)]
        prev = None
        for _r in range(20):
            ups = [x - 0.3 * (x - (target + s)) for s in shift]
            if quantized and prev is not None:
                g = qz.make_round_grid(prev, chunk_elems=1 << 14, mode="delta", expand=4.0)
                x_d = torch.from_numpy(x).to(device)
                qts = []
                for c, u in zip(comps, ups):
                    qts.append(c.quantize(
                        fl_comp.pack_tree({"w": torch.from_numpy(u).to(device)}, torch.float32), g, ref=x_d))
                    c.commit()
                agg = _np(fl_fedavg.packed_quantized_sum(qts, ref=x_d).buf)
            else:
                agg = np.mean(ups, axis=0).astype(np.float32)
            prev = agg - x
            x = agg
        return float(np.mean((x - target) ** 2))

    loss_f32 = conv(False)
    loss_q = conv(True)

    contrib_bytes = len(peers) * bundle16.buf.numel() * bundle16.buf.element_size()
    result_q.put((
        "cagg",
        {
            "bytes_frac": quant_bytes / bf16_bytes if bf16_bytes else 0.0,
            "bf16_bytes": bf16_bytes,
            "quant_bytes": quant_bytes,
            "round_ms_bf16": bf16_s / rounds * 1e3,
            "round_ms_quant": quant_s / rounds * 1e3,
            "gbps": contrib_bytes * rounds / quant_s / 1e9,
            "fold_speedup": dq_s / int_s if int_s else 0.0,
            "fold_int_gbps": fold_passes * len(codes) * n_elems / int_s / 1e9,
            "fold_dq_gbps": fold_passes * len(codes) * n_elems / dq_s / 1e9,
            "bitexact": bool(bitexact),
            "loss_ratio": loss_q / loss_f32 if loss_f32 else 0.0,
        },
    ))


def _run_secagg_bench(_party: str, result_q, device) -> None:
    """Masked rounds against plain quantized rounds (bench.py's leg): keys
    agreed over the real HELLO handshake, a local step per party per round
    (a 512×512 matmul chain on ``device``) under which the keystream
    prefetches, the integer fold and one rescale.  ``secagg_bitexact``:
    the masked aggregate's bytes equal the plain one's; the overhead is the
    min over three 3-pair block medians of order-balanced round deltas."""
    os.environ.setdefault("RAYFED_SECAGG_GROUP_KEY", "bench-secagg-key")

    from rayfed_tpu_torch.fl import compression as fl_comp
    from rayfed_tpu_torch.fl import quantize as qz
    from rayfed_tpu_torch.fl import secagg as sa
    from rayfed_tpu_torch.fl.streaming import StreamingAggregator

    parties = ("alice", "bob", "carol", "dave")
    mgrs = _managers(parties, device, device_put_received=False, zero_copy_host_arrays=True)
    # Key agreement over the real HELLO handshake: one ping per pair.
    for p in parties:
        mgrs[p].ensure_secagg_peer_keys(parties)

    n = 1 << 16
    ce = 1 << 16
    ref = np.linspace(-0.5, 0.5, n, dtype=np.float32)
    ref_d = torch.from_numpy(ref).to(device)
    tmpl = fl_comp.pack_tree({"w": ref_d}, torch.float32)
    rng = np.random.default_rng(0)
    grid = qz.make_round_grid(
        (1e-3 * rng.standard_normal(n)).astype(np.float32), mode="delta", expand=4.0, chunk_elems=ce,
    )
    weights = [2.0, 1.0, 3.0, 1.0]
    wmap = dict(zip(parties, weights))
    peers = [p for p in parties if p != "alice"]

    # The local step: a fixed matmul chain per party per round, the window
    # the mask PRG prefetch hides under.
    def _local_step(x):
        for _ in range(32):
            x = torch.tanh(x @ x) + 0.1
        _sync(device)
        return x

    step_x = torch.ones((512, 512), dtype=torch.float32, device=device) * 0.01

    def contribution(i: int, r: int):
        up = ref + (1e-3 * np.random.default_rng(100 * r + i).standard_normal(n)).astype(np.float32)
        return fl_comp.PackedTree(torch.from_numpy(up).to(device), tmpl.passthrough, tmpl.spec)

    def do_round(r: int, masked: bool):
        t0 = time.perf_counter()
        maskers = {}
        if masked:
            for p in parties:
                maskers[p] = sa.RoundMasker(
                    mgrs[p].secagg_keys, p, [q for q in parties if q != p],
                    session="bench", stream="sab", round_index=r, weight=int(wmap[p]),
                )
                # Prefetch the keystream under the local step, as the
                # round driver does.
                maskers[p].prefetch(n)
        wires = {}
        for i, p in enumerate(parties):
            _local_step(step_x)  # the local step
            up = contribution(i, r)
            if masked:
                wires[p] = sa.MaskedRoundCodec(grid, ref_d, None, maskers[p]).to_wire(up)
            else:
                wires[p] = qz.quantize_packed(up, grid, ref=ref_d)
        gd = qz.grid_descriptor(grid)
        tag = "m" if masked else "q"
        send_refs = [
            mgrs[p].send("alice", wires[p], f"sab-{tag}-{r}-{p}", "0", quant_meta=gd)
            for p in peers
        ]
        agg = StreamingAggregator(
            len(parties), weights=weights, quant=grid, quant_ref=ref_d, chunk_elems=ce,
            masked=masked, labels=list(parties), device=device,
        )
        for i, p in enumerate(peers):
            mgrs["alice"].recv_stream(p, f"sab-{tag}-{r}-{p}", "0", agg.sink(i + 1))
        agg.add_local(0, wires["alice"])
        result = agg.result(timeout=300)
        bcast = mgrs["alice"].send_many(peers, result, f"sabb-{tag}-{r}", "0")
        for p in peers:
            mgrs[p].recv("alice", f"sabb-{tag}-{r}", "0").resolve(timeout=300)
        for ref_ in send_refs + list(bcast.values()):
            if not ref_.resolve(timeout=300):
                raise RuntimeError("secagg bench round send failed")
        return time.perf_counter() - t0, result

    # Raw (unhidden) keystream cost: one party's net mask for one round.
    t0 = time.perf_counter()
    probe = sa.RoundMasker(
        mgrs["alice"].secagg_keys, "alice", list(peers),
        session="probe", stream="sab", round_index=0, weight=1,
    )
    probe.net_mask(n)
    mask_gen_s = time.perf_counter() - t0

    do_round(90, False)  # warm both stacks
    do_round(91, True)
    rounds = 9
    plain_walls, masked_walls = [], []
    plain_res = masked_res = None
    # Order-balanced pairs: the leg that goes first alternates.
    for r in range(rounds):
        if r % 2 == 0:
            w_p, plain_res = do_round(r, False)
            w_m, masked_res = do_round(r, True)
        else:
            w_m, masked_res = do_round(r, True)
            w_p, plain_res = do_round(r, False)
        plain_walls.append(w_p)
        masked_walls.append(w_m)
    # Same contributions each (r, masked) pair: the masks cancel exactly.
    bitexact = _raw_bytes(plain_res.buf) == _raw_bytes(masked_res.buf)
    from rayfed_tpu_torch.fl.secagg import SECAGG_STATS

    stats = {p: mgrs[p].get_stats()["secagg"] for p in parties}
    for m in mgrs.values():
        m.stop()
    plain_s = min(plain_walls)
    masked_s = min(masked_walls)
    deltas = [m - p for p, m in zip(plain_walls, masked_walls)]
    block_meds = [sorted(deltas[i: i + 3])[1] for i in range(0, len(deltas), 3)]
    result_q.put((
        "secagg",
        {
            "plain_round_ms": plain_s * 1e3,
            "masked_round_ms": masked_s * 1e3,
            "overhead_frac": max(0.0, min(block_meds) / plain_s),
            "bitexact": bool(bitexact),
            "mask_gen_ms": mask_gen_s * 1e3,
            "keygen_ms": float(SECAGG_STATS["keygen_ms"]),
            "suite": stats["alice"]["kex"] + "/" + stats["alice"]["prg"],
            "peers_keyed": min(len(stats[p]["peers"]) for p in parties),
        },
    ))


def _fill_secagg_extra(extra: dict, s: dict) -> None:
    extra["secagg_bitexact"] = s["bitexact"]
    extra["secagg_overhead_frac"] = round(s["overhead_frac"], 3)
    extra["secagg_round_ms"] = round(s["masked_round_ms"], 1)
    extra["secagg_plain_round_ms"] = round(s["plain_round_ms"], 1)
    extra["secagg_mask_gen_ms"] = round(s["mask_gen_ms"], 2)
    extra["secagg_keygen_ms"] = round(s["keygen_ms"], 2)
    extra["secagg_suite"] = s["suite"]
    extra["secagg_peers_keyed"] = s["peers_keyed"]
    _log(
        f"  secagg: masked round {s['masked_round_ms']:.0f} ms vs plain "
        f"quantized {s['plain_round_ms']:.0f} ms "
        f"({s['overhead_frac']:.1%} overhead; raw keystream "
        f"{s['mask_gen_ms']:.1f} ms/party hidden under the local step), "
        f"suite {s['suite']}, masked bytes "
        f"{'IDENTICAL' if s['bitexact'] else 'DIVERGED'} to unmasked"
    )


def _run_objectplane_bench(_party: str, result_q, device) -> None:
    """The content-addressed object plane (bench.py's leg): an eager
    welcome push against a cold and a warm welcome-by-handle rejoin (the
    warm one pulls nothing), and six concurrent fetches of one cold
    fingerprint collapsing to one wire transfer."""
    import threading

    from rayfed_tpu_torch import objects as rf_objects
    from rayfed_tpu_torch.fl import compression as fl_comp

    parties = ("alice", "bob", "carol", "dave")
    mgrs = _managers(parties, device, device_put_received=False, cross_silo_timeout_s=60)

    n = 1 << 20  # ~4 MB f32 model
    rng = np.random.default_rng(0)

    def model(r):
        w = rng.standard_normal(n).astype(np.float32) + r
        return fl_comp.pack_tree({"w": torch.from_numpy(w).to(device)}, torch.float32)

    def payload_bytes(mgr):
        return mgr.get_stats()["send_payload_bytes"]

    def welcome_of(m_r, handle=None):
        w = {"round": 1, "session": "op", "epoch": 1, "members": list(parties), "coordinator": "alice"}
        if handle is None:
            w["params"] = m_r
        else:
            w["model"] = handle
        return w

    # --- 1. eager welcome baseline (alice -> dave, params inline) ----
    m0 = model(0)
    m0c = rf_objects.canonical_host(m0)
    b0 = payload_bytes(mgrs["alice"])
    sent = mgrs["alice"].send("dave", welcome_of(m0), "w.eager", "roster")
    eager_val = mgrs["dave"].recv("alice", "w.eager", "roster").resolve(timeout=120)["params"]
    # The sender counts a frame's bytes after writing it, which may trail
    # the receiver's read: wait for the send to resolve before reading.
    sent.resolve(timeout=120)
    eager_bytes = payload_bytes(mgrs["alice"]) - b0

    # --- 2a. cold handle rejoin (carol has nothing cached) -----------
    fp, nb = mgrs["alice"].objects.publish(m0c)
    handle = mgrs["alice"].objects.handle_for(fp, nb)
    b1 = payload_bytes(mgrs["alice"])
    t0 = time.perf_counter()
    sent = mgrs["alice"].send("carol", welcome_of(None, handle), "w.cold", "roster")
    wc = mgrs["carol"].recv("alice", "w.cold", "roster").resolve(timeout=120)
    cold_val = rf_objects.maybe_resolve_handle(mgrs["carol"], wc["model"])
    cold_s = time.perf_counter() - t0
    sent.resolve(timeout=120)
    cold_bytes = payload_bytes(mgrs["alice"]) - b1

    # --- 2b. warm handle rejoin (dave's cache holds the model) -------
    mgrs["dave"].objects.publish(rf_objects.canonical_host(eager_val))
    b2 = payload_bytes(mgrs["alice"])
    sent = mgrs["alice"].send("dave", welcome_of(None, handle), "w.warm", "roster")
    ww = mgrs["dave"].recv("alice", "w.warm", "roster").resolve(timeout=120)
    warm_val = rf_objects.maybe_resolve_handle(mgrs["dave"], ww["model"])
    sent.resolve(timeout=120)
    warm_bytes = payload_bytes(mgrs["alice"]) - b2

    # Handle-resolved state == eager-push state, receiver-decoded.
    eager_b = _raw_bytes(eager_val.buf)
    identical = eager_b == _raw_bytes(cold_val.buf) and eager_b == _raw_bytes(warm_val.buf)

    # --- 3. concurrent-fetch single-transfer dedup -------------------
    m1 = model(1)
    fp1, nb1 = mgrs["alice"].objects.publish(rf_objects.canonical_host(m1))
    h1 = mgrs["alice"].objects.handle_for(fp1, nb1)
    serves0 = mgrs["alice"].objects.stats["blob_serves"]
    errs: list = []

    def _fetch():
        try:
            mgrs["bob"].objects.fetch(h1, timeout_s=120)
        except Exception as exc:  # pragma: no cover
            errs.append(exc)

    threads = [threading.Thread(target=_fetch) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    serves = mgrs["alice"].objects.stats["blob_serves"] - serves0
    dedup_ok = bool(not errs and serves == 1)

    for m in mgrs.values():
        m.stop()
    result_q.put((
        "object_plane",
        {
            "eager_welcome_bytes": int(eager_bytes),
            "cold_welcome_bytes": int(cold_bytes),
            "warm_welcome_bytes": int(warm_bytes),
            "rejoin_welcome_bytes_frac": warm_bytes / eager_bytes if eager_bytes else 1.0,
            "blob_pull_GBps": (nb / cold_s / 1e9) if cold_s > 0 else 0.0,
            "dedup_single_transfer": dedup_ok,
            "dedup_serves": int(serves),
            "handle_state_identical": bool(identical),
        },
    ))


def _fill_objectplane_extra(extra: dict, s: dict) -> None:
    extra["rejoin_welcome_bytes_frac"] = round(s["rejoin_welcome_bytes_frac"], 4)
    extra["blob_dedup_single_transfer"] = s["dedup_single_transfer"]
    extra["blob_handle_state_identical"] = s["handle_state_identical"]
    extra["blob_pull_GBps"] = round(s["blob_pull_GBps"], 3)
    extra["eager_welcome_bytes"] = s["eager_welcome_bytes"]
    extra["warm_welcome_bytes"] = s["warm_welcome_bytes"]
    _log(
        f"  object plane: warm rejoin {s['warm_welcome_bytes']} B vs "
        f"eager {s['eager_welcome_bytes']} B "
        f"(frac {s['rejoin_welcome_bytes_frac']:.4f}); cold pull "
        f"{s['blob_pull_GBps']:.2f} GB/s; dedup single transfer: "
        f"{s['dedup_single_transfer']} ({s['dedup_serves']} serve(s) "
        f"for 6 concurrent fetches)"
    )


# The hierarchy leg's sweep: (N, region_size, branch, hub leaves).  N <= 64
# keeps two regions of growing size; a second N=16 brackets the N=64 leg
# (the 64/16 gate divides by the slower of the two); N=256 is the
# multi-level leg, 16 regions of 16 through branch-4 interior nodes with
# quorum-hub leaves and the region-ring downlink.
HIER_SWEEP = ((4, 2, None, False), (16, 8, None, False), (64, 32, None, False),
              (16, 8, None, False), (256, 16, 4, True))


def _run_hierarchy_bench(_party: str, result_q, device) -> None:
    """Hierarchical aggregation traffic against N (bench.py's leg): N
    in-process virtual parties, one TransportManager each on loopback
    (shm local links), each driving ``HierarchyRound`` on ``device``.
    Per N: byte-exactness at every party against the one-shot
    ``packed_quantized_sum`` recoded by the shared downlink producer, mean
    per-party bytes and max-node ingress against 2·|model|, the round wall
    (min of 3, the flight recorder attributing phases at N ∈ {16, 64, 256}).
    At N=256 an FD-ceiling check first, then a seeded straggling-region
    chaos round that the per-region cutoff must absorb."""
    import gc
    import resource
    import threading

    from rayfed_tpu_torch import telemetry
    from rayfed_tpu_torch.fl import compression as fl_comp
    from rayfed_tpu_torch.fl import fedavg as fl_fedavg
    from rayfed_tpu_torch.fl import hierarchy as fl_hier
    from rayfed_tpu_torch.fl import quantize as qz
    from rayfed_tpu_torch.fl.hierarchy import HierarchyRound

    n_elems = 1 << 17  # 128Ki f32 elems; bf16 |model| = 256 KiB
    ce = 1 << 11  # 64 blocks
    model_bytes = 2 * n_elems  # bf16 bundle bytes (the |model| unit)
    ref = np.linspace(-0.5, 0.5, n_elems, dtype=np.float32)
    ref_d = torch.from_numpy(ref).to(device)
    tmpl = fl_comp.pack_tree({"w": ref_d}, torch.float32)
    rng = np.random.default_rng(0)
    grid = qz.make_round_grid(
        (1e-3 * rng.standard_normal(n_elems)).astype(np.float32), mode="delta", expand=4.0, chunk_elems=ce,
    )

    def contribution(i: int, r: int):
        up = ref + (1e-3 * np.random.default_rng(1000 * r + i).standard_normal(n_elems)).astype(np.float32)
        return fl_comp.PackedTree(torch.from_numpy(up).to(device), tmpl.passthrough, tmpl.spec)

    report: Dict[str, Any] = {"model_bytes": model_bytes}
    # N=256 packs ~256 listeners, local-link endpoints and the tree's lazy
    # per-peer connections into one process: raise the FD soft ceiling
    # toward the hard one and check the headroom before building them.
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < 16_384:
        try:
            resource.setrlimit(resource.RLIMIT_NOFILE, (min(16_384, hard), hard))
        except (ValueError, OSError):
            pass
        soft, _ = resource.getrlimit(resource.RLIMIT_NOFILE)
    report["fd_soft_limit"] = int(soft)

    for n_parties, region_size, branch, hub in HIER_SWEEP:
        if n_parties >= 256 and soft < 4_096:
            report["n256_skipped"] = f"fd soft ceiling {soft} < 4096 (hard {hard})"
            break
        parties = [f"h{i:03d}" for i in range(n_parties)]
        lay = fl_hier.region_layout(parties, region_size, branch=branch)
        hier_kw: Dict[str, Any] = {}
        if branch is not None:
            hier_kw["branch"] = branch
        if hub:
            # Full-region quorum for the measured rounds: the hub path is
            # exercised, no member is cut, bitexact covers all N.
            hier_kw["region_quorum"] = region_size
        # The topology this leg simulates is colocated: shm local links.
        mgrs = _managers(parties, device, device_put_received=False, zero_copy_host_arrays=True,
                         local_link="auto")

        def do_round(r: int, tag: str, delays=None, extra_kw=None):
            results, errors = {}, {}

            def run_party(p, i):
                try:
                    rnd = HierarchyRound(
                        mgrs[p], party=p, members=parties, region_size=region_size, grid=grid,
                        quant_ref=ref_d, keys=[f"{tag}{r}k{j}" for j in range(6)],
                        stream="hb", backstop=300, quant_downlink=True, device=device,
                        **{**hier_kw, **(extra_kw or {})},
                    )
                    if delays and p in delays:
                        time.sleep(delays[p])
                    results[p] = rnd.run(contribution(i, r))
                except BaseException as e:  # surfaces in the parent
                    errors[p] = e

            threads = [threading.Thread(target=run_party, args=(p, i), daemon=True)
                       for i, p in enumerate(parties)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(300)
            if errors:
                raise RuntimeError(
                    f"hierarchy round failed at N={n_parties}: { {p: repr(e) for p, e in errors.items()} }"
                )
            return time.perf_counter() - t0, results

        do_round(0, "w")  # warm: connections
        rx0 = {p: int(m.get_stats()["receive_bytes"]) for p, m in mgrs.items()}
        tx0 = {p: int(m.get_stats()["send_bytes"]) for p, m in mgrs.items()}
        traced = n_parties in (16, 64, 256)
        if traced:
            telemetry.install(f"hier_bench_n{n_parties}", capacity=1 << 20)
        rounds = 3
        walls = []
        results = None
        # N in-process parties make every collection pass walk N parties'
        # object graphs: simulation overhead, not transport work.
        gc.collect()
        gc.freeze()
        gc.disable()
        try:
            for r in range(1, 1 + rounds):
                wall, results = do_round(r, "m")
                walls.append(wall)
        finally:
            gc.enable()
            gc.unfreeze()
        trace_phases = None
        if traced:
            agg = collections.defaultdict(float)
            for rec in telemetry.active().records():
                if rec.phase and rec.dur_s:
                    agg[rec.phase] += rec.dur_s
            telemetry.uninstall()
            trace_phases = {ph: round(tot, 3) for ph, tot in sorted(agg.items(), key=lambda kv: -kv[1])}
        rx = {p: int(mgrs[p].get_stats()["receive_bytes"]) - rx0[p] for p in parties}
        tx = {p: int(mgrs[p].get_stats()["send_bytes"]) - tx0[p] for p in parties}
        link_backend = (
            mgrs[parties[0]].effective_transport_options(parties[1]).get("local_link", {}).get("backend")
        )

        # Seeded chaos (multi-level leg only): one region's members straggle
        # past the region deadline; the per-region cutoff absorbs them.
        chaos = None
        if hub:
            chaos_rng = np.random.default_rng(2026)
            cg = int(chaos_rng.integers(1, len(lay.regions)))
            coord_cg = lay.coordinators[cg]
            stragglers = [p for p in lay.live[cg] if p != coord_cg][:5]
            cutoffs0 = fl_hier.HIER_STATS["region_cutoffs"]
            aborted0 = fl_hier.HIER_STATS["rounds_aborted"]
            _, cres = do_round(
                9, "c", delays={p: 2.0 for p in stragglers},
                extra_kw={"region_quorum": region_size - len(stragglers), "region_deadline_s": 0.75},
            )
            cblobs = {_raw_bytes(t.buf) for t in cres.values()}
            chaos = {
                "straggler_region": cg,
                "stragglers": len(stragglers),
                "completed": len(cres),
                "cutoffs": int(fl_hier.HIER_STATS["region_cutoffs"] - cutoffs0),
                "fallbacks": int(fl_hier.HIER_STATS["rounds_aborted"] - aborted0),
                "agree": len(cblobs) == 1,
            }
        for m in mgrs.values():
            m.stop()

        # Byte-exactness against the one-shot compressed-domain reduce,
        # recoded by the shared downlink producer.
        last_r = rounds
        qts = [qz.quantize_packed(contribution(i, last_r), grid, ref=ref_d) for i in range(n_parties)]
        exact = fl_fedavg.packed_quantized_sum(qts, ref=ref_d)
        down = qz.make_round_grid(
            exact.buf.to(torch.float32) - ref_d, chunk_elems=ce, wire_dtype=grid.wire_dtype, mode="delta",
        )
        expect = qz.quantize_packed(exact, down, ref=ref_d).dequantize(torch.float32, ref=ref_d)
        blobs = {p: _raw_bytes(results[p].buf) for p in parties}
        bitexact = len(set(blobs.values())) == 1 and blobs[parties[0]] == _raw_bytes(expect.buf)
        total_rx = sum(rx.values())
        rkey = f"n{n_parties}"
        if rkey in report:
            rkey = f"n{n_parties}b"
        report[rkey] = {
            "bitexact": bool(bitexact),
            "party_bytes": total_rx / n_parties / rounds,
            "max_ingress": max(rx.values()) / rounds,
            "root_egress": tx[lay.root] / rounds,
            "round_s": min(walls),
            "link_backend": link_backend,
            "hub_max_ingress": (n_parties - 1) * n_elems,
        }
        if branch is not None:
            # Per-level max ingress, parties grouped by the highest tree
            # level they coordinate (0: plain member).
            role = {p: 0 for p in parties}
            for g in lay.active:
                role[lay.coordinators[g]] = 1
            for k, level in enumerate(lay.levels, start=2):
                for nd in level.values():
                    role[nd.coordinator] = max(role[nd.coordinator], k)
            by_role = collections.defaultdict(list)
            for p in parties:
                by_role[role[p]].append(rx[p])
            report[rkey]["per_level_ingress_frac"] = {
                f"l{k}": round(max(v) / rounds / (2.0 * model_bytes), 3) for k, v in sorted(by_role.items())
            }
        if chaos is not None:
            report[rkey]["chaos"] = chaos
        if trace_phases is not None:
            report[rkey]["trace_phases"] = trace_phases
    result_q.put(("hierarchy", report))


def _fill_hierarchy_extra(extra: dict, s: dict) -> None:
    model2 = 2.0 * s["model_bytes"]  # the 2·|model| flat-traffic budget
    bitexact = True
    for n in (4, 16, 64, 256):
        sec = s.get(f"n{n}")
        if sec is None:  # N=256 skipped below the FD ceiling
            continue
        bitexact = bitexact and sec["bitexact"]
        extra[f"hier_party_bytes_frac_{n}"] = round(sec["party_bytes"] / model2, 3)
        extra[f"hier_max_ingress_frac_{n}"] = round(sec["max_ingress"] / model2, 3)
        extra[f"hier_root_egress_frac_{n}"] = round(sec["root_egress"] / model2, 3)
        extra[f"hier_round_ms_{n}"] = round(sec["round_s"] * 1e3, 1)
    n16b = s.get("n16b")
    if n16b is not None:
        bitexact = bitexact and n16b["bitexact"]
        extra["hier_round_ms_16b"] = round(n16b["round_s"] * 1e3, 1)
    extra["hier_bitexact"] = bitexact
    extra["hier_link_backend"] = s["n64"].get("link_backend")
    # The N=64 wall as a ratio to the slower of the two N=16 walls.
    n16_wall = s["n16"]["round_s"]
    if n16b is not None:
        n16_wall = max(n16_wall, n16b["round_s"])
    extra["hier_round_ratio_64_over_16"] = round(s["n64"]["round_s"] / max(1e-9, n16_wall), 2)
    extra["hier_ingress_flatness"] = round(s["n64"]["max_ingress"] / max(1.0, s["n4"]["max_ingress"]), 3)
    extra["hier_vs_hub_max_ingress_64"] = round(
        s["n64"]["hub_max_ingress"] / max(1.0, s["n64"]["max_ingress"]), 2
    )
    n256 = s.get("n256")
    if n256 is not None:
        extra["hier_round_ratio_256_over_64"] = round(n256["round_s"] / max(1e-9, s["n64"]["round_s"]), 2)
        chaos = n256.get("chaos") or {}
        extra["hier_chaos_fallbacks"] = chaos.get("fallbacks")
        extra["hier_chaos_cutoffs"] = chaos.get("cutoffs")
        extra["hier_chaos_agree"] = chaos.get("agree")
        extra["hier_level_ingress_256"] = n256.get("per_level_ingress_frac")
    else:
        extra["hier_n256_skipped"] = s.get("n256_skipped", "missing")
    _log(
        f"  hierarchy: per-party bytes "
        f"{extra['hier_party_bytes_frac_4']:.2f}x / "
        f"{extra['hier_party_bytes_frac_16']:.2f}x / "
        f"{extra['hier_party_bytes_frac_64']:.2f}x of 2|model| at "
        f"N=4/16/64 (budget <= 1.25x), max-node ingress "
        f"{extra['hier_max_ingress_frac_4']:.2f}x / "
        f"{extra['hier_max_ingress_frac_16']:.2f}x / "
        f"{extra['hier_max_ingress_frac_64']:.2f}x "
        f"(N=64/N=4 flatness {extra['hier_ingress_flatness']:.2f}, "
        f"hub would be {extra['hier_vs_hub_max_ingress_64']:.1f}x "
        f"worse at N=64); bitexact={bitexact}; round "
        f"{extra['hier_round_ms_4']:.0f} / "
        f"{extra['hier_round_ms_16']:.0f} / "
        f"{extra['hier_round_ms_64']:.0f} ms "
        f"(N=16 re-bracket {extra.get('hier_round_ms_16b', '-')} ms; "
        f"64/16 ratio {extra['hier_round_ratio_64_over_16']:.1f}, "
        f"link={extra['hier_link_backend']})"
    )
    if n256 is not None:
        _log(
            f"  hierarchy N=256 (multi-level, 16 regions x 16, "
            f"branch=4): round {extra['hier_round_ms_256']:.0f} ms "
            f"(256/64 ratio "
            f"{extra['hier_round_ratio_256_over_64']:.1f}, gate <= 4), "
            f"root egress {extra['hier_root_egress_frac_256']:.2f}x of "
            f"2|model| (N=64: "
            f"{extra['hier_root_egress_frac_64']:.2f}x), per-level "
            f"ingress {extra['hier_level_ingress_256']}, chaos "
            f"straggling-region: {extra['hier_chaos_cutoffs']} "
            f"cutoff(s), {extra['hier_chaos_fallbacks']} fallback(s), "
            f"agree={extra['hier_chaos_agree']}"
        )
    else:
        _log(f"  hierarchy N=256 SKIPPED: {extra['hier_n256_skipped']}")


def _fill_compressed_extra(extra: dict, s: dict) -> None:
    extra["compressed_bytes_on_wire_frac"] = round(s["bytes_frac"], 3)
    extra["compressed_agg_GBps"] = round(s["gbps"], 3)
    extra["compressed_round_ms"] = round(s["round_ms_quant"], 1)
    extra["bf16_round_ms"] = round(s["round_ms_bf16"], 1)
    extra["compressed_fold_speedup"] = round(s["fold_speedup"], 3)
    extra["compressed_fold_int_GBps"] = round(s["fold_int_gbps"], 3)
    extra["compressed_fold_dequant_GBps"] = round(s["fold_dq_gbps"], 3)
    extra["compressed_agg_bitexact"] = s["bitexact"]
    extra["compressed_loss_ratio"] = round(s["loss_ratio"], 4)
    _log(
        f"  compressed-agg: {s['bytes_frac']:.3f}x the bf16 wire bytes "
        f"({s['quant_bytes'] / 1e6:.1f} vs {s['bf16_bytes'] / 1e6:.1f} "
        f"MB), fold {s['fold_speedup']:.2f}x vs dequant-first "
        f"({s['fold_int_gbps']:.2f} vs {s['fold_dq_gbps']:.2f} Gelem/s), "
        f"bitexact={s['bitexact']}, quadratic loss ratio "
        f"{s['loss_ratio']:.4f}; round {s['round_ms_quant']:.0f} ms vs "
        f"bf16 {s['round_ms_bf16']:.0f} ms"
    )


def _run_server_opt_bench(_party: str, result_q, device) -> None:
    """FedAC in the packed domain (bench.py's leg): (1) rounds and wall to
    the 2-party heterogeneous quadratic's target through the step and
    resync on ``device`` (``fold_fma`` on the card), (2) the same on the
    toy logistic workload (reported), (3) the post-step quantized downlink,
    decoded from its serialized wire bytes, byte-identical across the
    streaming fold, a quorum-cutoff subset refold and the hierarchy's
    regrouped presummed fold."""
    from rayfed_tpu_torch.fl import compression as fl_comp
    from rayfed_tpu_torch.fl import fedavg as fl_fedavg
    from rayfed_tpu_torch.fl import quantize as qz
    from rayfed_tpu_torch.fl import server_opt as so
    from rayfed_tpu_torch.fl.streaming import StreamingAggregator
    from rayfed_tpu_torch.transport import wire as wire_mod

    # --- 1. quadratic rounds/wall-to-target ----------------------------
    size = 1 << 14
    rng = np.random.default_rng(11)
    opt_point = rng.normal(size=(size,)).astype(np.float32)
    shift = 0.3 * rng.normal(size=(size,)).astype(np.float32)
    curv = np.linspace(0.02, 0.12, size).astype(np.float32)
    tmpl = fl_comp.pack_tree({"w": torch.zeros(size, device=device)}, torch.float32)
    target = 1e-3 * float(np.mean(opt_point**2))
    opt_d, curv_d = torch.from_numpy(opt_point).to(device), torch.from_numpy(curv).to(device)
    shifts_d = (torch.from_numpy(shift).to(device), torch.from_numpy(-shift).to(device))

    def quad_run(opt_spec, max_rounds=450):
        runner = so.PackedServerOptimizer(opt_spec, device=device) if opt_spec is not None else None
        x = torch.zeros(size, dtype=torch.float32, device=device)
        t0 = time.perf_counter()
        for r in range(max_rounds):
            ups = [x - curv_d * (x - (opt_d + s)) for s in shifts_d]
            avg = (ups[0] + ups[1]) / 2
            if runner is not None:
                runner.ensure(x)
                res = fl_comp.PackedTree(avg, tmpl.passthrough, tmpl.spec)
                new_x = runner.step_fn(x)(res).buf
                runner.resync(x, new_x)
                x = new_x
            else:
                x = avg
            # The loss on the host in numpy, as the reference reads it.
            if float(np.mean((_np(x) - opt_point) ** 2)) <= target:
                return r + 1, time.perf_counter() - t0
        return max_rounds, time.perf_counter() - t0

    quad_run(so.fedac(1.0, 6.0, 0.7), max_rounds=3)  # warmup
    plain_rounds, plain_wall = quad_run(None)
    fedac_rounds, fedac_wall = quad_run(so.fedac(1.0, 6.0, 0.7))

    # --- 2. toy logistic (reported, not gated) -------------------------
    from rayfed_tpu_torch.models import logistic

    d, classes, n = 64, 5, 2048
    xs, ys = [], []
    w_true = torch.randn(d, classes, generator=torch.Generator().manual_seed(9)).to(device)
    for i in range(2):
        xp = torch.randn(n, d, generator=torch.Generator().manual_seed(i + 1)).to(device)
        xs.append(xp)
        ys.append(torch.argmax(xp @ w_true, dim=-1))
    step_fn = logistic.make_train_step(logistic.apply_logistic, lr=0.3)
    ptree0 = logistic.init_logistic(d, classes, device=device)

    def log_loss(params):
        tot = 0.0
        for xp, yp in zip(xs, ys):
            tot += float(logistic.softmax_cross_entropy(logistic.apply_logistic(params, xp), yp))
        return tot / 2

    def log_run(opt_spec, target_loss, max_rounds=80):
        runner = so.PackedServerOptimizer(opt_spec, device=device) if opt_spec is not None else None
        params = ptree0
        losses = []
        t0 = time.perf_counter()
        for r in range(max_rounds):
            ups = []
            for xp, yp in zip(xs, ys):
                local = params
                for _ in range(4):
                    local, _l = step_fn(local, xp, yp)
                ups.append(fl_comp.pack_tree(local, torch.float32))
            avg = fl_fedavg.packed_weighted_sum(ups, out_dtype="float32")
            if runner is not None:
                x = fl_comp.pack_tree(params, torch.float32).buf
                runner.ensure(x)
                new_x = runner.step_fn(x)(avg).buf
                runner.resync(x, new_x)
                avg = fl_comp.PackedTree(new_x, avg.passthrough, avg.spec)
            params = avg.unpack(torch.float32)
            losses.append(log_loss(params))
            if target_loss is not None and losses[-1] <= target_loss:
                return r + 1, losses, time.perf_counter() - t0
        return max_rounds, losses, time.perf_counter() - t0

    log_run(None, None, max_rounds=2)  # warmup, both timed paths
    log_run(so.fedac(1.0, 2.0, 0.3), None, max_rounds=2)
    _, plain_losses, _w = log_run(None, None)
    # The target plain FedAvg needs ~70% of its budget to reach.
    log_target = plain_losses[int(0.7 * len(plain_losses)) - 1]
    log_plain_rounds, _ls, log_plain_wall = log_run(None, log_target)
    log_fedac_rounds, _ls2, log_fedac_wall = log_run(so.fedac(1.0, 2.0, 0.3), log_target)

    # --- 3. post-step downlink byte-identity across topologies ---------
    from rayfed_tpu_torch import native
    from rayfed_tpu_torch.fl.compression import PackSpec
    from rayfed_tpu_torch.fl.hierarchy import RegionSumTree, partial_sum_dtype

    ce = 1 << 12
    asize = 40_000
    ref = rng.normal(size=(asize,)).astype(np.float32)
    ref_d = torch.from_numpy(ref).to(device)
    packeds = [
        fl_comp.pack_tree(
            {"w": torch.from_numpy(ref + 0.01 * rng.normal(size=(asize,)).astype(np.float32)).to(device)},
            torch.float32,
        )
        for _ in range(4)
    ]
    grid = qz.make_round_grid(
        0.01 * rng.normal(size=(asize,)).astype(np.float32), chunk_elems=ce, mode="delta", expand=4.0,
    )
    ws = [3, 1, 2, 1]
    qts = [qz.quantize_packed(p, grid, ref=ref_d) for p in packeds]
    opt_spec = so.fedac(1.0, 3.0, 0.5)

    def payload_of(tree):
        bufs = wire_mod.encode_payload(tree)
        return native.gather_copy([memoryview(b) if isinstance(b, (bytes, bytearray)) else b for b in bufs])

    def step_and_downlink(result):
        runner = so.PackedServerOptimizer(opt_spec, device=device)
        runner.ensure(ref_d)
        stepped = runner.step_fn(ref_d)(result)
        wire_result, decoded, _descr = qz.quantize_downlink(stepped, grid, ref_d, None)
        # Decode from the serialized bytes, as a receiver would.
        got = wire_mod.decode_payload(memoryview(payload_of(wire_result)), zero_copy=True)
        receiver = got.dequantize(torch.float32, ref=ref_d)
        return _raw_bytes(decoded.buf), _raw_bytes(receiver.buf)

    def stream_fold(indices, weights):
        agg = StreamingAggregator(len(indices), weights=weights, chunk_elems=ce, quant=grid, quant_ref=ref_d,
                                  device=device)
        for j, i in enumerate(indices):
            agg.add_local(j, qts[i])
        return agg.result(timeout=120)

    bitexact = True
    coord_full, recv_full = step_and_downlink(stream_fold([0, 1, 2, 3], ws))
    bitexact &= coord_full == recv_full
    ps_dt = partial_sum_dtype(grid.qabs_max, sum(ws))
    region_sums = []
    for members in ((0, 1), (2, 3)):
        acc = np.zeros(grid.total_elems, np.int64)
        for i in members:
            acc += ws[i] * _np(qts[i].buf).astype(np.int64)
        spec = PackSpec(qts[0].spec.entries, qts[0].spec.treedef, ps_dt)
        region_sums.append(RegionSumTree(acc.astype(np.dtype(ps_dt)), grid.scales, grid.zps, (), spec,
                                         grid.meta()))
    root = StreamingAggregator(
        2, weights=[float(ws[0] + ws[1]), float(ws[2] + ws[3])], chunk_elems=ce, quant=grid,
        quant_ref=ref_d, presummed=ps_dt, device=device,
    )
    for g, rs in enumerate(region_sums):
        root.add_local(g, rs)
    hier_coord, hier_recv = step_and_downlink(root.result(timeout=120))
    bitexact &= hier_coord == coord_full
    bitexact &= hier_recv == recv_full
    # Quorum-cutoff subset feeding the step: equal to the one-shot subset
    # reduce and the same step.
    qagg = StreamingAggregator(
        4, weights=ws, chunk_elems=ce, quant=grid, quant_ref=ref_d, quorum=3, labels=["a", "b", "c", "d"],
        device=device,
    )
    qagg.sink(1)  # never arrives
    for i in (0, 2, 3):
        qagg.add_local(i, qts[i])
    cut = qagg.result(timeout=120, deadline_s=0.4)
    cut_coord, cut_recv = step_and_downlink(cut)
    subset = fl_fedavg.packed_quantized_sum([qts[0], qts[2], qts[3]], [ws[0], ws[2], ws[3]], ref=ref_d)
    sub_coord, sub_recv = step_and_downlink(subset)
    bitexact &= cut_coord == sub_coord
    bitexact &= cut_recv == sub_recv
    bitexact &= cut_coord == cut_recv

    result_q.put((
        "sopt",
        {
            "plain_rounds": plain_rounds,
            "fedac_rounds": fedac_rounds,
            "rounds_frac": fedac_rounds / plain_rounds,
            "quad_plain_wall_s": plain_wall,
            "quad_fedac_wall_s": fedac_wall,
            "plain_wall_s": log_plain_wall,
            "fedac_wall_s": log_fedac_wall,
            "wall_frac": log_fedac_wall / log_plain_wall if log_plain_wall else 0.0,
            "log_plain_rounds": log_plain_rounds,
            "log_fedac_rounds": log_fedac_rounds,
            "log_frac": log_fedac_rounds / log_plain_rounds,
            "bitexact": bool(bitexact),
        },
    ))


def _fill_server_opt_extra(extra: dict, s: dict) -> None:
    extra["fedavg_rounds_to_target"] = s["plain_rounds"]
    extra["fedac_rounds_to_target"] = s["fedac_rounds"]
    extra["fedac_rounds_to_target_frac"] = round(s["rounds_frac"], 3)
    extra["fedavg_wall_to_target_s"] = round(s["plain_wall_s"], 3)
    extra["fedac_wall_to_target_s"] = round(s["fedac_wall_s"], 3)
    extra["fedac_wall_to_target_frac"] = round(s["wall_frac"], 3)
    extra["fedac_logistic_rounds_frac"] = round(s["log_frac"], 3)
    extra["server_opt_agg_bitexact"] = s["bitexact"]
    _log(
        f"  server-opt: FedAC reaches the quadratic target in "
        f"{s['fedac_rounds']} rounds vs plain {s['plain_rounds']} "
        f"(frac {s['rounds_frac']:.3f}; wall frac {s['wall_frac']:.3f}"
        f"), logistic frac {s['log_frac']:.3f}, post-step downlink "
        f"bitexact across streaming/quorum-subset/hierarchy = "
        f"{s['bitexact']}"
    )


def _run_send_path_bench(_party: str, result_q, device, kw: Optional[dict] = None) -> None:
    """The coordinator's send path (bench.py's leg): (N-1) packed bf16
    bundles in, the aggregate out, against sequential single-payload pushes
    of the same bundle (``wire_vs_push_capability``), the send/read phase
    walls, the transfer-log sessions and the per-stage breakdown; then the
    same push shape over a colocated pair with ``local_link`` "auto" (the
    in-process shm handoff) and "uds"."""
    from rayfed_tpu_torch.fl import compression as fl_comp

    smoke = bool(os.environ.get("RAYFED_BENCH_SMOKE"))
    parties = ("alice", "bob", "carol", "dave")
    mgrs = _managers(parties, device, device_put_received=False, zero_copy_host_arrays=True)

    if smoke:
        # ~24 MB bf16 packed bundle: 6 wire chunks.
        tree = {f"l{i}": torch.arange(3_000_000, dtype=torch.float32, device=device) * 1e-6 + i
                for i in range(4)}
        rounds = 3
    else:
        from rayfed_tpu_torch.models import resnet

        tree = resnet.init_resnet(torch.Generator().manual_seed(0), resnet.resnet18(num_classes=10), device=device)
        rounds = _kw(kw, "rounds", 3)
    bundle = fl_comp.compress(tree, packed=True)
    _sync(device)
    bundle_bytes = bundle.buf.numel() * bundle.buf.element_size()
    peers = [p for p in parties if p != "alice"]
    # Distinct per-peer contributions, built outside the window.
    contribs = {p: fl_comp.PackedTree(bundle.buf.clone(), bundle.passthrough, bundle.spec) for p in peers}

    def do_round(r):
        t0 = time.perf_counter()
        send_refs = [mgrs[p].send("alice", contribs[p], f"c{r}-{p}", "0") for p in peers]
        got = [mgrs["alice"].recv(p, f"c{r}-{p}", "0").resolve(timeout=300) for p in peers]
        t_in = time.perf_counter()
        bcast = mgrs["alice"].send_many(peers, got[0], f"b{r}", "0")
        for p in peers:
            mgrs[p].recv("alice", f"b{r}", "0").resolve(timeout=300)
        for ref in send_refs + list(bcast.values()):
            if not ref.resolve(timeout=300):
                raise RuntimeError("send-path bench send failed")
        t_end = time.perf_counter()
        return t_in - t0, t_end - t_in

    do_round(0)  # warmup: connections, codec pools
    log = mgrs["alice"].transfer_log
    total0 = log.total_recorded
    stats0 = mgrs["alice"].get_stats()
    bk0 = stats0["send_path_breakdown_ms"]
    comms_wall = float("inf")
    wall_ratios = []
    for r in range(1, rounds + 1):
        in_s, out_s = do_round(r)
        comms_wall = min(comms_wall, in_s + out_s)
        wall_ratios.append(out_s / in_s)
    wall_ratios.sort()
    wall_ratio = wall_ratios[len(wall_ratios) // 2]  # median
    recs, complete = log.records_since(total0)
    stats1 = mgrs["alice"].get_stats()
    bk1 = stats1["send_path_breakdown_ms"]

    # In-situ capability: sequential single-payload pushes, alice → bob.
    cap_wall = float("inf")
    for rep in range(2):
        t0 = time.perf_counter()
        for i in range(3):
            ref = mgrs["alice"].send("bob", bundle, f"cap{rep}-{i}", "0")
            mgrs["bob"].recv("alice", f"cap{rep}-{i}", "0").resolve(timeout=300)
            if not ref.resolve(timeout=300):
                raise RuntimeError("capability probe send failed")
        cap_wall = min(cap_wall, time.perf_counter() - t0)
    cap_gbps = 3 * bundle_bytes / cap_wall / 1e9
    for m in mgrs.values():
        m.stop()

    # Local-link leg: the same push shape over a fresh colocated pair, once
    # per backend ("auto" takes the in-process shm handoff).
    local_legs = {}
    for mode in ("auto", "uds"):
        lm = _managers(("alice", "bob"), device, device_put_received=False, zero_copy_host_arrays=True,
                       local_link=mode)
        la, lb = lm["alice"], lm["bob"]
        ref = la.send("bob", bundle, f"lw-{mode}", "0")  # warm + decide
        lb.recv("alice", f"lw-{mode}", "0").resolve(timeout=300)
        if not ref.resolve(timeout=300):
            raise RuntimeError(f"local-link warm send failed ({mode})")
        lwall = float("inf")
        for rep in range(2):
            t0 = time.perf_counter()
            for i in range(3):
                ref = la.send("bob", bundle, f"l{mode}{rep}-{i}", "0")
                lb.recv("alice", f"l{mode}{rep}-{i}", "0").resolve(timeout=300)
                if not ref.resolve(timeout=300):
                    raise RuntimeError(f"local-link probe send failed ({mode})")
            lwall = min(lwall, time.perf_counter() - t0)
        backend = la.effective_transport_options("bob").get("local_link", {}).get("backend")
        local_legs[mode] = {"gbps": 3 * bundle_bytes / lwall / 1e9, "backend": backend}
        la.stop()
        lb.stop()

    if not complete:
        raise RuntimeError("transfer log ring evicted the bench window")
    read_s = sum(r.seconds for r in recs if r.direction == "recv" and r.up_id.startswith("c"))
    send_s = sum(r.seconds for r in recs if r.direction == "send" and r.up_id.startswith("b"))
    coord_bytes = 2 * len(peers) * bundle_bytes
    wire_gbps = coord_bytes / comms_wall / 1e9
    result_q.put((
        "send_path",
        {
            "wire_gbps": wire_gbps,
            "cap_gbps": cap_gbps,
            "vs_cap": wire_gbps / cap_gbps if cap_gbps > 0 else None,
            "wall_ratio": wall_ratio,
            "read_ms": read_s / rounds * 1e3,
            "send_ms": send_s / rounds * 1e3,
            "overhead_ratio": send_s / read_s if read_s > 0 else None,
            "bundle_mb": bundle_bytes / 1e6,
            "breakdown_ms": {k: round(bk1[k] - bk0[k], 2) for k in bk1},
            "striped_payloads": stats1["send_striped_payloads"] - stats0["send_striped_payloads"],
            "local_legs": local_legs,
        },
    ))


def _fill_send_path_extra(extra: dict, s: dict) -> None:
    extra["cross_party_wire_GBps"] = round(s["wire_gbps"], 3)
    extra["send_path_wire_GBps"] = round(s["wire_gbps"], 3)
    extra["push_capability_GBps"] = round(s["cap_gbps"], 3)
    extra["wire_vs_push_capability"] = round(s["vs_cap"], 3) if s["vs_cap"] else None
    extra["send_vs_read_wall_ratio"] = round(s["wall_ratio"], 3)
    extra["coord_wire_read_ms"] = round(s["read_ms"], 2)
    extra["coord_send_path_ms"] = round(s["send_ms"], 2)
    extra["send_path_overhead_ratio"] = round(s["overhead_ratio"], 3) if s["overhead_ratio"] else None
    extra["send_path_breakdown_ms"] = s["breakdown_ms"]
    extra["send_path_striped_payloads"] = s["striped_payloads"]
    legs = s.get("local_legs") or {}
    if legs:
        extra["local_link_GBps"] = round(legs["auto"]["gbps"], 3)
        extra["local_link_backend"] = legs["auto"]["backend"]
        extra["local_link_uds_GBps"] = round(legs["uds"]["gbps"], 3)
        extra["local_link_vs_wire"] = round(legs["auto"]["gbps"] / max(1e-9, s["wire_gbps"]), 2)
    _log(
        f"  send path: {s['wire_gbps']:.3f} GB/s FedAvg-path wire vs "
        f"{s['cap_gbps']:.3f} GB/s push capability "
        f"({s['vs_cap']:.2f} of capability) — "
        f"{s['bundle_mb']:.1f} MB bundles, {s['striped_payloads']} "
        f"striped payloads; send/read phase-wall ratio "
        f"{s['wall_ratio']:.2f}; "
        f"coordinator read {s['read_ms']:.1f} ms vs send "
        f"{s['send_ms']:.1f} ms session sum per round "
        f"({s['overhead_ratio'] or 0.0:.2f}x); breakdown {s['breakdown_ms']}"
    )
    if legs:
        _log(
            f"  local link: {legs['auto']['gbps']:.3f} GB/s "
            f"{legs['auto']['backend']} / "
            f"{legs['uds']['gbps']:.3f} GB/s {legs['uds']['backend']} "
            f"vs {s['wire_gbps']:.3f} GB/s tcp wire "
            f"({extra['local_link_vs_wire']:.1f}x, gate >= 2.0)"
        )


RINGB_PARTIES = ("alice", "bob", "carol", "dave")


def _run_ring_agg_party(party: str, result_q, device, cluster, kw: Optional[dict] = None) -> None:
    """Ring against hub FedAvg rounds over the fed API (bench.py's leg; one
    process per party): ``streaming_aggregate`` into alice against
    ``ring_aggregate``'s striped reduce-scatter and all-gather, each
    party's ingress bytes per phase, then the quantized ring against the
    f32 ring on cold streams."""
    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch.fl import compression as fl_comp
    from rayfed_tpu_torch.fl.ring import ring_aggregate
    from rayfed_tpu_torch.fl.streaming import streaming_aggregate
    from rayfed_tpu_torch.runtime import get_runtime

    smoke = bool(os.environ.get("RAYFED_BENCH_SMOKE"))
    fed.init(address="local", cluster=cluster, party=party, device=device)

    if smoke:
        tree = _smoke_tree(device)
        rounds = 2
        chunk_elems = 1 << 19  # 1 MB bf16 blocks: 12 blocks / 4 stripes
    else:
        from rayfed_tpu_torch.models import resnet

        tree = resnet.init_resnet(torch.Generator().manual_seed(0), resnet.resnet18(num_classes=10), device=device)
        rounds = _kw(kw, "rounds", 3)
        chunk_elems = None  # the canonical grid

    bundle = fl_comp.compress(tree, packed=True)
    bundle_bytes = bundle.buf.numel() * bundle.buf.element_size()
    base32, contribution = _rotating_quarter(bundle)
    n_elems = base32.numel()
    produce = fed.remote(contribution)

    def do_rounds(mode: str, r0: int, nrounds: int) -> float:
        t0 = time.perf_counter()
        for r in range(r0, r0 + nrounds):
            objs = [produce.party(p).remote(i, r) for i, p in enumerate(RINGB_PARTIES)]
            if mode == "ring":
                out = ring_aggregate(objs, stream="rg", chunk_elems=chunk_elems)
            else:
                out = streaming_aggregate(objs, stream="hub", coordinator=RINGB_PARTIES[0])
            out.buf[:64].cpu()  # touch: the round really landed
        return time.perf_counter() - t0

    def ingress() -> int:
        return int(get_runtime().transport.get_stats()["receive_bytes"])

    report = {"bundle_mb": bundle_bytes / 1e6}
    for mode in ("hub", "ring"):
        do_rounds(mode, 0, 1)  # warmup: seeds delta caches
        in0 = ingress()
        report[f"{mode}_s"] = do_rounds(mode, 1, rounds)
        report[f"{mode}_in"] = ingress() - in0

    # Quantized ring against the f32 ring, cold streams each round on both.
    from rayfed_tpu_torch.fl import quantize as qz

    q_ce = chunk_elems if chunk_elems else (1 << 21)
    q_rng = np.random.default_rng(7)
    q_grid = qz.make_round_grid(
        (5e-3 * q_rng.standard_normal(n_elems)).astype(np.float32), mode="delta", expand=4.0, chunk_elems=q_ce,
    )

    def do_rounds_cold(tag: str, use_quant: bool, r0: int, nrounds: int) -> float:
        t0 = time.perf_counter()
        for r in range(r0, r0 + nrounds):
            objs = [produce.party(p).remote(i, r) for i, p in enumerate(RINGB_PARTIES)]
            out = ring_aggregate(
                objs, stream=f"{tag}{r}", chunk_elems=q_ce,
                quant=q_grid if use_quant else None, quant_ref=base32 if use_quant else None,
            )
            out.buf[:64].cpu()  # touch: the round really landed
        return time.perf_counter() - t0

    do_rounds_cold("rfw", False, 0, 1)  # warm (f32 out path)
    in0 = ingress()
    report["ringf_s"] = do_rounds_cold("rfc", False, 1, rounds)
    report["ringf_in"] = ingress() - in0
    do_rounds_cold("rqw", True, 0, 1)  # warm the quantized path
    in0 = ingress()
    report["ringq_s"] = do_rounds_cold("rqc", True, 1, rounds)
    report["ringq_in"] = ingress() - in0

    report["rounds"] = rounds
    if result_q is not None:
        result_q.put((party, report))
    fed.shutdown()


def _ring_bench_metrics(res: dict) -> dict:
    """Reduce the per-party ring-leg reports to the headline metrics."""
    coord = RINGB_PARTIES[0]
    rounds = res[coord]["rounds"]
    bundle = res[coord]["bundle_mb"] * 1e6
    hub_wall = sum(v["hub_s"] for v in res.values()) / len(res)
    ring_wall = sum(v["ring_s"] for v in res.values()) / len(res)
    total_ring_in = sum(v["ring_in"] for v in res.values())
    total_hub_in = sum(v["hub_in"] for v in res.values())
    return {
        "ring_agg_GBps": round(len(res) * bundle * rounds / ring_wall / 1e9, 3),
        "ring_vs_coord_speedup": round(hub_wall / ring_wall, 3),
        "coord_bytes_in_frac": round(res[coord]["ring_in"] / total_ring_in, 3),
        "coord_bytes_in_frac_hub": round(res[coord]["hub_in"] / total_hub_in, 3),
        "ring_coord_ingress_vs_hub": round(res[coord]["ring_in"] / max(1, res[coord]["hub_in"]), 3),
        "ring_round_ms": round(ring_wall / rounds * 1e3, 1),
        "hub_round_ms": round(hub_wall / rounds * 1e3, 1),
        "ring_bundle_mb": round(bundle / 1e6, 1),
        "ring_quant_bytes_frac": round(
            sum(v["ringq_in"] for v in res.values()) / max(1, sum(v["ringf_in"] for v in res.values())), 3
        ),
        "ring_quant_round_ms": round(sum(v["ringq_s"] for v in res.values()) / len(res) / rounds * 1e3, 1),
        "ring_f32cold_round_ms": round(sum(v["ringf_s"] for v in res.values()) / len(res) / rounds * 1e3, 1),
    }


def _fill_ring_extra(extra: dict, res: dict) -> None:
    m = _ring_bench_metrics(res)
    extra.update(m)
    _log(
        f"  ring-agg: {m['ring_agg_GBps']:.3f} GB/s logical through the "
        f"ring round; coordinator takes {m['coord_bytes_in_frac']:.0%} "
        f"of cluster ingress (hub: {m['coord_bytes_in_frac_hub']:.0%}), "
        f"{m['ring_coord_ingress_vs_hub']:.2f}x its hub ingress bytes; "
        f"round {m['ring_round_ms']:.0f} ms vs hub "
        f"{m['hub_round_ms']:.0f} ms "
        f"(speedup {m['ring_vs_coord_speedup']:.2f}x); quantized ring "
        f"{m['ring_quant_bytes_frac']:.3f}x the bf16 ring's bytes, round "
        f"{m['ring_quant_round_ms']:.0f} ms vs f32-cold "
        f"{m['ring_f32cold_round_ms']:.0f} ms"
    )


CHAOSB_PARTIES = ("alice", "bob", "carol", "dave")
# Fast death detection only for the party the schedule crashes: a loaded
# but healthy coordinator must never be declared dead by global knobs.
CHAOSB_DAVE_OPTIONS = {"heartbeat_interval_s": 0.3, "death_deadline_s": 0.9}
CHAOSB_ROUNDS = 3
CHAOSB_DEADLINE_S = 3.0


def _chaos_cluster() -> dict:
    cluster = _cluster(CHAOSB_PARTIES)
    cluster["dave"]["transport_options"] = dict(CHAOSB_DAVE_OPTIONS)
    return cluster


def _run_chaos_party(party: str, result_q, device, cluster) -> None:
    """Quorum rounds under injected faults (bench.py's leg; one process per
    party): ``run_fedavg_rounds(quorum=2, round_deadline_s=3)`` with carol
    straggling 8 s in round 1, dave crashing hard at the same boundary, and
    alice, the coordinator, crashing in round 2 between its cutoff and the
    broadcast.  Every survivor must finish every round on the same bytes."""
    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch import chaos
    from rayfed_tpu_torch.fl import compression as fl_comp
    from rayfed_tpu_torch.fl import run_fedavg_rounds
    from rayfed_tpu_torch.fl.quorum import QUORUM_STATS

    chaos.install({
        "seed": 11,
        "rules": [
            {"hook": "round", "party": "carol", "match": {"round": 1}, "op": "delay_ms", "value": 8000},
            {"hook": "round", "party": "dave", "match": {"round": 1}, "op": "crash_party"},
            # Kill the coordinator after round 2's cutoff pinned the member
            # set but before anyone heard the result.
            {"hook": "announce", "party": "alice", "match": {"round": 2}, "op": "crash_party"},
        ],
    })

    dim = 1024
    deltas = {p: 0.25 * (i + 1) for i, p in enumerate(CHAOSB_PARTIES)}

    # Warm the ops the round touches, as the reference warms its programs:
    # the first deadline must measure the protocol.
    params = {"w": torch.zeros((dim,), dtype=torch.float32, device=device)}
    packed = fl_comp.compress(params, packed=True, wire_dtype=torch.float32)
    from rayfed_tpu_torch.fl.fedavg import DEFAULT_CHUNK_ELEMS, finalize_packed_stripe, packed_weighted_sum
    from rayfed_tpu_torch.fl.overlap import dga_correct
    from rayfed_tpu_torch.fl.streaming import _fold_block

    for n in (2, 3, 4):
        packed_weighted_sum([packed] * n, None)
    dga_correct(packed, packed, packed)
    acc = torch.zeros(DEFAULT_CHUNK_ELEMS, dtype=torch.float32, device=device)
    _fold_block(acc, 0, torch.zeros(DEFAULT_CHUNK_ELEMS, dtype=torch.float32, device=device), 1.0)
    finalize_packed_stripe(acc, 2.0, dim, torch.float32)
    _sync(device)

    fed.init(
        address="local", cluster=cluster, party=party, device=device,
        enable_waiting_for_other_parties_ready=True,
        peer_health_interval_in_seconds=1.0, peer_death_pings=3,
        cross_silo_timeout_in_seconds=15,
        cross_silo_retry_policy={"maxAttempts": 2, "initialBackoff": "0.2s", "maxBackoff": "0.5s"},
        recv_backstop_in_seconds=120,
    )

    @fed.remote
    class Trainer:
        def __init__(self, delta):
            self._d = float(delta)

        def train(self, p):
            tree = fl_comp.decompress(p, torch.float32)
            return fl_comp.compress({"w": tree["w"] + self._d}, packed=True, wire_dtype=torch.float32)

    trainers = {p: Trainer.party(p).remote(deltas[p]) for p in CHAOSB_PARTIES}
    log: list = []
    t0 = time.perf_counter()
    try:
        final = run_fedavg_rounds(
            trainers, params, rounds=CHAOSB_ROUNDS, compress_wire=True, packed_wire=True,
            wire_dtype=torch.float32, quorum=2, round_deadline_s=CHAOSB_DEADLINE_S, round_log=log,
            coordinator=CHAOSB_PARTIES[0],
        )
    except chaos.ChaosPartyCrash:
        # Hard crash: report, then die without any goodbye (the queue's
        # feeder thread flushes first).
        if result_q is not None:
            result_q.put((party, {"crashed": True}))
            result_q.close()
            result_q.join_thread()
        os._exit(0)
    wall = time.perf_counter() - t0
    buf = _np(final["w"]).astype(np.float32)
    report = {
        "crashed": False,
        "rounds": len(log),
        "round1_members": sorted(next(e for e in log if e["round"] == 1)["members"]),
        "final_crc": int(np.frombuffer(buf.tobytes(), np.uint8).sum()),
        "final_head": float(buf[0]),
        # The final roster epoch (log entries carry round-start epochs).
        "epoch": int(fed.runtime.get_runtime().transport.roster.epoch),
        "coordinator_failovers": int(QUORUM_STATS["coordinator_failovers"]),
        "final_coordinator": log[-1]["coordinator"],
        "wall_s": wall,
    }
    if result_q is not None:
        result_q.put((party, report))
    fed.shutdown()


def _fill_chaos_extra(extra: dict, res: dict) -> None:
    survivors = {p: r for p, r in res.items() if not r.get("crashed")}
    crashed = [p for p, r in res.items() if r.get("crashed")]
    finals = {(r["final_crc"], r["final_head"]) for r in survivors.values()}
    extra["chaos_survivors"] = len(survivors)
    extra["chaos_crashed_parties"] = crashed
    extra["chaos_rounds_completed"] = min((r["rounds"] for r in survivors.values()), default=0)
    extra["chaos_round1_members"] = next(iter(survivors.values()))["round1_members"] if survivors else []
    extra["chaos_final_consistent"] = len(finals) == 1
    extra["chaos_roster_epoch"] = max((r["epoch"] for r in survivors.values()), default=0)
    # Gate on the minimum: one stale controller cannot hide behind others.
    extra["chaos_coordinator_failovers"] = min(
        (r.get("coordinator_failovers", 0) for r in survivors.values()), default=0
    )
    extra["chaos_final_coordinator"] = next((r.get("final_coordinator") for r in survivors.values()), None)
    extra["chaos_round_wall_s"] = round(
        max((r["wall_s"] for r in survivors.values()), default=0.0) / max(1, CHAOSB_ROUNDS), 2,
    )
    _log(
        f"  chaos: {len(survivors)} survivors completed "
        f"{extra['chaos_rounds_completed']}/{CHAOSB_ROUNDS} rounds under "
        f"1 straggler + 2 crashes (incl. the coordinator mid-round); "
        f"round-1 quorum {extra['chaos_round1_members']}, roster epoch "
        f"{extra['chaos_roster_epoch']}, "
        f"{extra['chaos_coordinator_failovers']} failovers (lease now at "
        f"{extra['chaos_final_coordinator']}), finals "
        f"{'IDENTICAL' if extra['chaos_final_consistent'] else 'DIVERGED'}"
    )


TELEB_PARTIES = ("alice", "bob", "carol", "dave")


def _run_telemetry_bench(_party: str, result_q, device) -> None:
    """The flight recorder's cost and fidelity (bench.py's leg): the stream
    agg round in paired disarmed/armed measurements (order swapped every
    other pair; the gate value is the min over three 8-pair block medians
    of the relative deltas), then an armed window collected from every
    peer over TRACE_GET/TRACE_PUT, merged, exported to Perfetto and read by
    ``tool/trace_report`` against the driver's own walls."""
    from rayfed_tpu_torch import telemetry
    from rayfed_tpu_torch.fl import compression as fl_comp
    from rayfed_tpu_torch.fl.streaming import StreamingAggregator
    from tool.trace_report import round_report

    parties = TELEB_PARTIES
    mgrs = _managers(parties, device, device_put_received=False, zero_copy_host_arrays=True)
    bundle = fl_comp.compress(_smoke_tree(device), packed=True)
    _, contribution = _rotating_quarter(bundle)
    peers = [p for p in parties if p != "alice"]

    def do_round(r: int) -> float:
        t0_wall = time.time()
        t0 = time.perf_counter()
        contribs = {p: contribution(i + 1, r) for i, p in enumerate(peers)}
        send_refs = [
            mgrs[p].send("alice", contribs[p], f"t{r}-{p}", "0", stream=f"tele/up/{p}", round_tag=r)
            for p in peers
        ]
        agg = StreamingAggregator(len(parties), party="alice", device=device)
        for i, p in enumerate(peers):
            mgrs["alice"].recv_stream(p, f"t{r}-{p}", "0", agg.sink(i + 1))
        agg.add_local(0, contribution(0, r))
        result = agg.result(timeout=300)
        bcast = mgrs["alice"].send_many(peers, result, f"tb{r}", "0", stream="tele/down", round_tag=r)
        for p in peers:
            out = mgrs[p].recv("alice", f"tb{r}", "0").resolve(timeout=300)
            out.buf[:64].cpu()  # touch: decode really happened
        for ref in send_refs + list(bcast.values()):
            if not ref.resolve(timeout=300):
                raise RuntimeError("telemetry bench send failed")
        wall = time.perf_counter() - t0
        # The driver's round record: disarmed this is one global read.
        telemetry.emit("driver.round", party="alice", round=r, t_start=t0_wall, dur_s=wall,
                       detail={"local_s": 0.0})
        return wall

    reps = 7  # the collect/report window
    probe_pairs = 24
    do_round(0)  # warmup: seeds every delta cache
    assert telemetry.installed() is None
    disarmed = []
    armed_probe = []
    r_next = 1
    for k in range(probe_pairs):
        if k % 2 == 0:
            disarmed.append(do_round(r_next))
            r_next += 1
            telemetry.install()  # throwaway ring: overhead probe only
            armed_probe.append(do_round(r_next))
            r_next += 1
            telemetry.uninstall()
        else:
            telemetry.install()
            armed_probe.append(do_round(r_next))
            r_next += 1
            telemetry.uninstall()
            disarmed.append(do_round(r_next))
            r_next += 1
    deltas = [(a - d) / d for a, d in zip(armed_probe, disarmed)]

    def _median(xs):
        xs = sorted(xs)
        mid = len(xs) // 2
        return xs[mid] if len(xs) % 2 else 0.5 * (xs[mid - 1] + xs[mid])

    block = len(deltas) // 3
    overhead_frac = min(_median(deltas[i * block: (i + 1) * block]) for i in range(3))

    # The collect/report window: one recorder across reps armed rounds.
    telemetry.install()  # party=None: every seam stamps its own party
    armed_r0 = r_next
    armed = [do_round(armed_r0 + i) for i in range(reps)]

    me = "alice"
    rec = telemetry.installed()
    party_records = {me: [x for x in rec.records() if x.party is None or x.party == me]}
    offsets = {me: {"offset_s": 0.0, "rtt_s": 0.0, "bound_s": 0.0}}
    for p in peers:
        records, offset, rep_meta = mgrs[me].collect_trace(p, timeout_s=60)
        if not rep_meta["armed"]:
            raise RuntimeError(f"peer {p} served a disarmed trace window")
        party_records[p] = records
        offsets[p] = offset
    merged = telemetry.merge_records(party_records, offsets)
    perfetto = telemetry.to_trace_events(merged, offsets)
    report = round_report(merged, tolerance=0.25)

    agrees = True
    for i, wall in enumerate(armed):
        info = report.get(armed_r0 + i)
        if info is None or not info["wall_agrees"]:
            agrees = False
            break
        if abs(info["wall_s"] - wall) > 0.25 * max(wall, info["wall_s"]):
            agrees = False
            break
    if not perfetto.get("traceEvents"):
        agrees = False

    spans_from = {str(d.get("party")) for d in merged if d.get("phase") != "driver.round"}
    stats = rec.stats()
    telemetry.uninstall()
    for m in mgrs.values():
        m.stop()
    result_q.put((
        "solo",
        {
            "overhead_frac": overhead_frac,
            "agrees": agrees,
            "disarmed_wall_s": min(disarmed),
            "armed_wall_s": min(armed),
            "merged_records": len(merged),
            "parties_with_spans": sorted(spans_from),
            "trace_dropped": stats["trace_dropped"],
        },
    ))


def _fill_telemetry_extra(extra: dict, s: dict) -> None:
    extra["trace_overhead_frac"] = round(s["overhead_frac"], 4)
    extra["trace_critical_path_agrees"] = bool(s["agrees"] and len(s["parties_with_spans"]) == len(TELEB_PARTIES))
    extra["trace_merged_records"] = s["merged_records"]
    extra["trace_dropped"] = s["trace_dropped"]
    _log(
        f"  telemetry: armed round wall {s['armed_wall_s'] * 1e3:.1f} ms "
        f"vs disarmed {s['disarmed_wall_s'] * 1e3:.1f} ms (overhead "
        f"{100 * s['overhead_frac']:+.2f}%); merged "
        f"{s['merged_records']} records from "
        f"{len(s['parties_with_spans'])} parties "
        f"({s['trace_dropped']} dropped); critical path "
        f"{'agrees' if extra['trace_critical_path_agrees'] else 'DISAGREES'}"
    )


ASYNCB_PARTIES = ("coord", "p1", "p2", "p3", "p4")  # p4 is the straggler
ASYNCB_DIM = 4096
ASYNCB_BASE_S = 0.05  # deterministic per-step "compute" (sleep)
ASYNCB_LR = 0.5
ASYNCB_TARGET_FRAC = 0.05  # stop when excess loss <= 5% of initial
ASYNCB_SYNC_ROUNDS = 6  # fixed sync schedule; target lands ~round 3
ASYNCB_CHAOS = {
    "seed": 11,
    "rules": [{"hook": "local_step", "party": "p4", "op": "local_slowdown", "value": [2.0, 10.0]}],
}
ASYNCB_N64 = 64  # versions/sec leg: 1 coordinator + 63 members


def _run_async_bench(_party: str, result_q, device) -> None:
    """Buffered asynchronous rounds against the synchronous barrier
    (bench.py's leg), in-process virtual parties on ``device``: (1) time
    to the target loss under a seeded 2-10x straggler on p4, a thread
    barrier against ``run_async_fleet(buffer_k=3)``, every emitted version
    byte-equal to the sorted refold of its fold set; (2) versions per
    second of a 64-party fleet with no chaos and no compute sleep."""
    import threading

    from rayfed_tpu_torch import chaos
    from rayfed_tpu_torch.fl import async_rounds as ar
    from rayfed_tpu_torch.fl import run_async_fleet
    from rayfed_tpu_torch.fl.compression import PackedTree
    from rayfed_tpu_torch.fl.fedavg import as_tensor, packed_quantized_sum

    rng = np.random.default_rng(7)
    c_vec = (0.25 + 0.5 * rng.random(ASYNCB_DIM)).astype(np.float32)
    # Random init, not zeros: version 0's grid is an abs-mode grid over the
    # initial params, which must cover the early contributions.
    w0 = rng.random(ASYNCB_DIM).astype(np.float32)
    c_d = torch.from_numpy(c_vec).to(device)

    def loss(w):
        return float(0.5 * np.mean((w - c_vec) ** 2))

    loss0 = loss(w0)
    target = ASYNCB_TARGET_FRAC * loss0
    members = [p for p in ASYNCB_PARTIES if p != "coord"]

    def _local_step(party, packed, version, cycle):
        buf = as_tensor(packed.buf, device).to(torch.float32)
        time.sleep(ASYNCB_BASE_S)
        new = buf + ASYNCB_LR * (c_d - buf)
        return PackedTree(new, packed.passthrough, packed.spec)

    # Warm the quantize and fold paths outside the timed legs.
    run_async_fleet(["coord", "p1"], {"w": w0}, _local_step, cycles=2, buffer_k=1, timeout_s=120, device=device)
    ar.reset_async_stats()

    # --- sync leg: thread-barrier FedAvg under the chaos schedule ---
    chaos.install(ASYNCB_CHAOS)
    barrier = threading.Barrier(len(members))
    model = {"w": torch.from_numpy(w0.copy()).to(device)}
    contribs: dict = {}
    sync_curve: list = []
    t0 = time.time()

    def _sync_member(p):
        for rnd in range(ASYNCB_SYNC_ROUNDS):
            w = model["w"]
            t1 = time.perf_counter()
            time.sleep(ASYNCB_BASE_S)
            new = w + ASYNCB_LR * (c_d - w)
            _sync(device)
            dur = time.perf_counter() - t1
            chaos.fire("local_step", p, version=rnd, cycle=rnd, baseline_s=dur)
            contribs[p] = new
            if barrier.wait() == 0:
                total = contribs[members[0]]
                for m in members[1:]:
                    total = total + contribs[m]
                model["w"] = total / len(members)
                sync_curve.append((time.time() - t0, loss(_np(model["w"]))))
            barrier.wait()

    threads = [threading.Thread(target=_sync_member, args=(p,), daemon=True) for p in members]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    chaos.uninstall()
    tt_sync = next((t for t, l in sync_curve if l <= target), None)

    # --- async leg: same workload, same chaos schedule, no barrier ---
    chaos.install(ASYNCB_CHAOS)
    vlog: list = []
    folds: list = []
    t0 = time.time()
    out = run_async_fleet(
        ASYNCB_PARTIES, {"w": w0}, _local_step,
        cycles={"p1": 10, "p2": 10, "p3": 10, "p4": 4},
        # Weight 16: a stale contribution lands decayed (16 >> s), not out.
        weights={p: 16 for p in members},
        buffer_k=3, timeout_s=120, version_log=vlog, record_folds=folds, device=device,
    )
    chaos.uninstall()
    leg1_hist = {str(k): v for k, v in ar.ASYNC_STATS["staleness_hist"].items()}
    tt_async = next((r["t_wall"] - t0 for r in vlog if loss(r["model"][:ASYNCB_DIM]) <= target), None)

    # Per-version refold oracle: the buffered fold is order-free.
    by_v = collections.defaultdict(list)
    for f in folds:
        if f["w_eff"] > 0:
            by_v[f["version"]].append(f)
    bitexact = bool(vlog)
    prev_model = None
    for rec in vlog:
        fset = sorted(by_v[rec["version"] - 1], key=lambda f: f["party"])
        if not fset:
            bitexact = False
            break
        qts = [f["qt"] for f in fset]
        ref = None
        if qts[0].grid().mode == "delta":
            ref = torch.from_numpy(prev_model).to(device)
        oracle = packed_quantized_sum(qts, [f["w_eff"] for f in fset], ref=ref)
        if _raw_bytes(oracle.buf) != _raw_bytes(rec["model"]):
            bitexact = False
            break
        prev_model = rec["model"]

    # --- N=64 throughput leg: no chaos, no compute sleep ---
    c_head = c_d[:256]

    def _fast_step(party, packed, version, cycle):
        buf = as_tensor(packed.buf, device).to(torch.float32)
        new = buf + ASYNCB_LR * (c_head - buf)
        return PackedTree(new, packed.passthrough, packed.spec)

    ar.reset_async_stats()
    n64 = ["coord"] + [f"m{i:02d}" for i in range(ASYNCB_N64 - 1)]
    t1 = time.time()
    out64 = run_async_fleet(
        n64, {"w": w0[:256]}, _fast_step, cycles=2, weights={p: 16 for p in n64[1:]},
        buffer_k=8, timeout_s=240, device=device,
    )
    n64_wall = time.time() - t1

    result_q.put(("solo", {
        "tt_sync_s": tt_sync,
        "tt_async_s": tt_async,
        "sync_wall_s": sync_curve[-1][0] if sync_curve else None,
        "versions": out["versions"],
        "folds": out["folds"],
        "staleness_hist": leg1_hist,
        "refold_bitexact": bitexact,
        "n64_versions": out64["versions"],
        "n64_folds": out64["folds"],
        "n64_wall_s": n64_wall,
    }))


def _fill_async_extra(extra: dict, s: dict) -> None:
    tt_a, tt_s = s["tt_async_s"], s["tt_sync_s"]
    extra["async_tt_frac"] = round(tt_a / tt_s, 3) if tt_a is not None and tt_s else None
    extra["async_time_to_target_s"] = round(tt_a, 3) if tt_a is not None else None
    extra["sync_time_to_target_s"] = round(tt_s, 3) if tt_s is not None else None
    extra["async_refold_bitexact"] = bool(s["refold_bitexact"])
    extra["async_versions"] = s["versions"]
    extra["async_staleness_hist"] = s["staleness_hist"]
    extra["async_versions_per_sec"] = round(s["n64_versions"] / s["n64_wall_s"], 2) if s["n64_wall_s"] else None
    extra["async_n64_wall_s"] = round(s["n64_wall_s"], 3)
    _log(
        f"  async: time-to-target {tt_a if tt_a is None else round(tt_a, 3)}s "
        f"vs sync {tt_s if tt_s is None else round(tt_s, 3)}s "
        f"(frac {extra['async_tt_frac']}); {s['versions']} versions / "
        f"{s['folds']} folds, staleness hist {s['staleness_hist']}, "
        f"refold {'bit-exact' if extra['async_refold_bitexact'] else 'MISMATCH'}; "
        f"N=64: {s['n64_versions']} versions in {s['n64_wall_s']:.2f}s "
        f"({extra['async_versions_per_sec']}/s, {s['n64_folds']} folds)"
    )


OVERLAPB_PARTIES = ("alice", "bob", "carol", "dave")


def _run_overlap_party(party: str, result_q, device, cluster, kw: Optional[dict] = None) -> None:
    """Pipelined (``overlap=True``) against synchronous FedAvg rounds
    (bench.py's leg; one process per party): the same matmul-chain trainer
    on ``device`` through ``run_fedavg_rounds`` both ways from one warmed
    state.  ``overlap_hidden_comm_frac`` is Σ hidden_s / Σ agg_s over the
    pipelined rounds."""
    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch.fl import run_fedavg_rounds

    smoke = bool(os.environ.get("RAYFED_BENCH_SMOKE"))
    fed.init(address="local", cluster=cluster, party=party, device=device)

    # A small bundle (dim=512: 0.5 MB bf16) keeps the comms wall the round's
    # fixed latency; 50 steps of the chain are the compute it hides under.
    dim = 512
    steps = 50
    rounds = 6 if smoke else _kw(kw, "rounds", 8)

    @fed.remote
    class Trainer:
        def __init__(self, seed: int):
            gen = torch.Generator().manual_seed(seed)
            self._a = (torch.randn(dim, dim, generator=gen) / math.sqrt(dim)).to(device)

        def train(self, params):
            from rayfed_tpu_torch.fl import compression as C

            w = C.decompress(params, torch.float32)["w"].to(device)
            for _ in range(steps):
                w = 0.99 * w + 0.01 * torch.tanh(self._a @ w)
            out = C.compress({"w": w}, packed=True)
            # Materialize inside the train body, so the compute is not
            # billed to the comms lane's payload encode.
            _sync(device)
            return out

    params = {"w": torch.randn(dim, dim, generator=torch.Generator().manual_seed(99)).to(device)}
    trainers = {p: Trainer.party(p).remote(i) for i, p in enumerate(OVERLAPB_PARTIES)}

    def run(overlap: bool, nrounds: int, timings=None):
        kw = {"overlap": True} if overlap else {"streaming_agg": True}
        t0 = time.perf_counter()
        out = run_fedavg_rounds(trainers, params, rounds=nrounds, compress_wire=True, packed_wire=True,
                                timings=timings, **kw)
        out["w"].cpu()
        return time.perf_counter() - t0

    run(False, 1)  # warmup: delta-cache seed
    run(True, 2)  # warmup: lane spin-up
    sync_t: list = []
    sync_s = run(False, rounds, timings=sync_t)
    ov_t: list = []
    overlap_s = run(True, rounds, timings=ov_t)

    report = {
        "rounds": rounds,
        "sync_s": sync_s,
        "overlap_s": overlap_s,
        "hidden_s": sum(r["hidden_s"] for r in ov_t),
        "agg_s": sum(r["agg_s"] for r in ov_t),
        "local_s": sum(r["local_s"] for r in ov_t),
        "sync_agg_s": sum(r["agg_s"] for r in sync_t),
    }
    if result_q is not None:
        result_q.put((party, report))
    fed.shutdown()


def _overlap_bench_metrics(res: dict) -> dict:
    n = len(res)
    rounds = next(iter(res.values()))["rounds"]
    sync_wall = sum(v["sync_s"] for v in res.values()) / n
    ov_wall = sum(v["overlap_s"] for v in res.values()) / n
    hidden = sum(v["hidden_s"] for v in res.values())
    agg = sum(v["agg_s"] for v in res.values())
    return {
        "overlap_hidden_comm_frac": round(hidden / max(agg, 1e-9), 3),
        "round_wall_speedup": round(sync_wall / ov_wall, 3),
        "overlap_round_ms": round(ov_wall / rounds * 1e3, 1),
        "sync_round_ms": round(sync_wall / rounds * 1e3, 1),
        "overlap_comms_ms_per_round": round(agg / n / rounds * 1e3, 1),
        "overlap_local_ms_per_round": round(sum(v["local_s"] for v in res.values()) / n / rounds * 1e3, 1),
    }


def _fill_overlap_extra(extra: dict, res: dict) -> None:
    m = _overlap_bench_metrics(res)
    extra.update(m)
    _log(
        f"  overlap: {m['overlap_hidden_comm_frac']:.0%} of the comms "
        f"wall hidden under local compute "
        f"(comms {m['overlap_comms_ms_per_round']:.0f} ms under local "
        f"{m['overlap_local_ms_per_round']:.0f} ms per round); round "
        f"{m['overlap_round_ms']:.0f} ms vs sync "
        f"{m['sync_round_ms']:.0f} ms "
        f"(speedup {m['round_wall_speedup']:.2f}x)"
    )


def _fill_stream_extra(extra: dict, s: dict) -> None:
    extra["cross_party_stream_agg_GBps"] = round(s["gbps"], 3)
    extra["agg_overlap_frac"] = round(s["overlap"], 3)
    extra["delta_bytes_saved_frac"] = round(s["delta_saved"], 3)
    extra["stream_agg_round_ms"] = round(s["round_ms"], 1)
    extra["stream_agg_contrib_ms"] = round(s["contrib_agg_ms"], 1)
    extra["stream_agg_bcast_ms"] = round(s["bcast_ms"], 1)
    extra["stream_agg_busy_ms"] = round(s["agg_busy_ms"], 1)
    extra["stream_agg_tail_ms"] = round(s["agg_tail_ms"], 1)
    extra["stream_agg_wire_ms"] = round(s["agg_wire_ms"], 1)
    extra["stream_agg_bundle_mb"] = round(s["bundle_mb"], 1)
    _log(
        f"  stream-agg: {s['gbps']:.3f} GB/s through receive+aggregate, "
        f"overlap {s['overlap']:.0%} of agg busy hidden under the wire, "
        f"delta cache saved {s['delta_saved']:.0%} of stream bytes; "
        f"round {s['round_ms']:.0f} ms = contrib+agg "
        f"{s['contrib_agg_ms']:.0f} + bcast {s['bcast_ms']:.0f} "
        f"(agg busy {s['agg_busy_ms']:.0f}, tail {s['agg_tail_ms']:.0f})"
    )


# --------------------------------------------------------------------------
# Processes: each leg runs in spawned children, as bench.py's do
# --------------------------------------------------------------------------

def _launches() -> Dict[str, int]:
    """This process's kernel launches so far, as each wrapper counts them
    where it launches its kernel (a CPU run launches none)."""
    import importlib

    fold = importlib.import_module("rayfed_tpu_torch.ops.fold")
    flash = importlib.import_module("rayfed_tpu_torch.ops.flash_attention").flash_attention
    norm = importlib.import_module("rayfed_tpu_torch.ops.rms_norm").rms_norm
    out = {"fold_fma": fold.fold_fma_.launches}
    for k in ("fwd", "bwd_dq", "bwd_dkv"):
        out[f"flash_{k}"] = getattr(flash, f"{k}_launches")
    for k in ("fwd", "bwd", "dscale"):
        out[f"rms_norm_{k}"] = getattr(norm, f"{k}_launches")
    return out


def _peak_bytes() -> Optional[int]:
    """This process's peak device memory so far (None without the card)."""
    return torch.cuda.max_memory_allocated() if torch.cuda.is_initialized() else None


def _assert_no_jax() -> None:
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in _FOREIGN)
    if loaded:
        raise AssertionError(f"a bench_torch child loaded {loaded}")


class _NoJaxQueue:
    """The child's end of the result queue: every report first asserts that
    the child loaded neither JAX nor the JAX package, and carries the
    child's kernel launches and peak device memory so far."""

    def __init__(self, q):
        self._q = q

    def put(self, item) -> None:
        _assert_no_jax()
        self._q.put((*item, _launches(), _peak_bytes()))

    def close(self) -> None:
        self._q.close()

    def join_thread(self) -> None:
        self._q.join_thread()


def _party_child(fn_name: str, party: str, result_q, device: str, args: tuple = (),
                 smoke: Optional[bool] = None) -> None:
    """Spawn-process entry: run the leg ``fn_name`` for ``party`` on
    ``device``.  Nothing touches the card before this process starts.
    ``smoke`` True or False sets or clears ``RAYFED_BENCH_SMOKE`` here
    (None: as inherited), so that a federated leg runs at its full size
    whatever another section running beside it set in the parent."""
    if smoke is not None:
        if smoke:
            os.environ["RAYFED_BENCH_SMOKE"] = "1"
        else:
            os.environ.pop("RAYFED_BENCH_SMOKE", None)
    globals()[fn_name](party, _NoJaxQueue(result_q), device, *args)


def _one_child(fn_name: str, device: str, launches, timeout: int = 300, args: tuple = (),
               peaks: Optional[list] = None, smoke: Optional[bool] = None):
    """Run a leg in one spawned child; returns what it reported."""
    return next(iter(_multi_party(fn_name, ("solo",), device, launches, args, timeout, peaks, smoke).values()))


def _multi_party(fn_name: str, parties, device: str, launches, args: tuple = (), timeout: int = 900,
                 peaks: Optional[list] = None, smoke: Optional[bool] = None) -> dict:
    """Run a leg in one spawned child per party; returns each child's
    report by the name it reported under, adds the children's kernel
    launches to the Counter ``launches`` and their peak device memory to
    the list ``peaks`` (when given); ``smoke`` as ``_party_child``'s."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_party_child, args=(fn_name, p, q, device, args, smoke)) for p in parties]
    for p in procs:
        p.start()
    results = {}
    deadline = time.time() + timeout
    while len(results) < len(parties) and time.time() < deadline:
        try:
            party, value, child_launches, peak = q.get(timeout=5)
            results[party] = value
            launches.update(child_launches)
            if peaks is not None and peak is not None:
                peaks.append(peak)
        except Exception:
            # Fail fast: a crashed child, or every child gone with results
            # still missing, means no full set is coming.
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if all(p.exitcode is not None for p in procs) and q.empty():
                break
    for p in procs:
        p.join(30)
        if p.is_alive():
            p.terminate()
    if len(results) < len(parties):
        raise RuntimeError(f"benchmark failed; partial results: {results}")
    return results


@contextlib.contextmanager
def _section(extra: dict, name: str):
    """Isolate one leg: a failure records ``{name}_error`` and the other
    legs still run and report."""
    try:
        yield
    except Exception as e:
        _log(f"  section {name} FAILED: {e!r}")
        extra[f"{name}_error"] = repr(e)[:200]


# --------------------------------------------------------------------------
# The legs in bench.py's order, and the gate table
# --------------------------------------------------------------------------

def _leg_stream_agg(device, extra, launches):
    _fill_stream_extra(extra, _one_child("_run_stream_agg_bench", device, launches, timeout=420))


def _leg_ring_agg(device, extra, launches):
    res = _multi_party("_run_ring_agg_party", RINGB_PARTIES, device, launches, (_cluster(RINGB_PARTIES),), timeout=420)
    _fill_ring_extra(extra, res)


def _leg_overlap(device, extra, launches):
    res = _multi_party("_run_overlap_party", OVERLAPB_PARTIES, device, launches, (_cluster(OVERLAPB_PARTIES),),
                       timeout=420)
    _fill_overlap_extra(extra, res)


def _leg_send_path(device, extra, launches):
    _fill_send_path_extra(extra, _one_child("_run_send_path_bench", device, launches, timeout=420))


def _leg_compressed_agg(device, extra, launches):
    _fill_compressed_extra(extra, _one_child("_run_compressed_agg_bench", device, launches, timeout=420))


def _leg_secagg(device, extra, launches):
    _fill_secagg_extra(extra, _one_child("_run_secagg_bench", device, launches, timeout=420))


def _leg_server_opt(device, extra, launches):
    _fill_server_opt_extra(extra, _one_child("_run_server_opt_bench", device, launches, timeout=420))


def _leg_object_plane(device, extra, launches):
    _fill_objectplane_extra(extra, _one_child("_run_objectplane_bench", device, launches, timeout=420))


def _leg_hierarchy(device, extra, launches):
    _fill_hierarchy_extra(extra, _one_child("_run_hierarchy_bench", device, launches, timeout=600))


def _leg_chaos(device, extra, launches):
    res = _multi_party("_run_chaos_party", CHAOSB_PARTIES, device, launches, (_chaos_cluster(),), timeout=420)
    _fill_chaos_extra(extra, res)


def _leg_telemetry(device, extra, launches):
    _fill_telemetry_extra(extra, _one_child("_run_telemetry_bench", device, launches, timeout=420))


def _leg_async_rounds(device, extra, launches):
    _fill_async_extra(extra, _one_child("_run_async_bench", device, launches, timeout=600))


# (section, what it runs, runner), in bench.py --smoke's order.
LEGS = (
    ("stream_agg", "streaming-aggregation smoke (small bundles, 4 parties)", _leg_stream_agg),
    ("ring_agg", "ring-aggregation smoke (4-party ring vs hub)", _leg_ring_agg),
    ("overlap", "pipelined-rounds smoke (4-party overlap vs sync)", _leg_overlap),
    ("send_path", "coordinator send-path smoke (4-party hub, arena + multi-rail, local link)", _leg_send_path),
    ("compressed_agg", "compressed-domain aggregation smoke (shared-grid uint8 folds vs bf16, 4 parties)",
     _leg_compressed_agg),
    ("secagg", "secure-aggregation smoke (pairwise-masked integer folds vs plain quantized rounds, 4 parties)",
     _leg_secagg),
    ("server_opt", "server-optimization smoke (FedAC rounds-to-target + post-step downlink byte-identity)",
     _leg_server_opt),
    ("object_plane", "object-plane smoke (welcome-by-handle vs eager push, concurrent-fetch dedup)",
     _leg_object_plane),
    ("hierarchy", "hierarchical-aggregation smoke (traffic-vs-N at N=4/16/64, multi-level N=256)",
     _leg_hierarchy),
    ("chaos", "chaos smoke (quorum=2 under a straggler, a party crash and a coordinator kill, 4 parties)",
     _leg_chaos),
    ("telemetry", "telemetry smoke (flight-recorder overhead + cross-manager critical path, 4 managers)",
     _leg_telemetry),
    ("async_rounds", "buffered-async smoke (time-to-target vs sync barrier + versions/sec at N=64)",
     _leg_async_rounds),
)
LEG_NAMES = tuple(name for name, _, _ in LEGS)


class Gate(NamedTuple):
    """One gate of ``bench.py``'s smoke mode: ``key`` of the record held by
    ``op`` to ``threshold``.  ``kind`` is "exact" (fixed by sizes, seeds and
    the arithmetic) or "timed" (a ratio of walls); ``leg`` is the section
    that sets ``key``; ``requires`` names a key whose absence skips the
    gate (the N=256 leg below the FD ceiling)."""

    name: str
    key: str
    op: str
    threshold: Any
    kind: str
    leg: str
    requires: Optional[str] = None


_OPS = {
    "<=": lambda v, t: v <= t,
    ">=": lambda v, t: v >= t,
    "==": lambda v, t: v == t,
    "is": lambda v, t: v is t,
    "true": lambda v, t: bool(v),
    "len_in": lambda v, t: t[0] <= len(v) < t[1],
}

_N256 = "hier_round_ratio_256_over_64"

# Every gate of bench.py --smoke, thresholds unchanged, in its order.
GATES = (
    Gate("compressed_bytes_on_wire_frac", "compressed_bytes_on_wire_frac", "<=", 0.55, "exact", "compressed_agg"),
    Gate("compressed_fold_speedup", "compressed_fold_speedup", ">=", 1.0, "timed", "compressed_agg"),
    Gate("compressed_agg_bitexact", "compressed_agg_bitexact", "true", None, "exact", "compressed_agg"),
    Gate("compressed_loss_ratio", "compressed_loss_ratio", "<=", 1.05, "exact", "compressed_agg"),
    Gate("fedac_rounds_to_target_frac", "fedac_rounds_to_target_frac", "<=", 0.8, "exact", "server_opt"),
    Gate("server_opt_agg_bitexact", "server_opt_agg_bitexact", "true", None, "exact", "server_opt"),
    Gate("secagg_bitexact", "secagg_bitexact", "true", None, "exact", "secagg"),
    Gate("secagg_overhead_frac", "secagg_overhead_frac", "<=", 0.05, "timed", "secagg"),
    Gate("rejoin_welcome_bytes_frac", "rejoin_welcome_bytes_frac", "<=", 0.1, "exact", "object_plane"),
    Gate("blob_dedup_single_transfer", "blob_dedup_single_transfer", "true", None, "exact", "object_plane"),
    Gate("blob_handle_state_identical", "blob_handle_state_identical", "true", None, "exact", "object_plane"),
    Gate("hier_bitexact", "hier_bitexact", "true", None, "exact", "hierarchy"),
    *(Gate(f"hier_party_bytes_frac_{n}", f"hier_party_bytes_frac_{n}", "<=", 1.25, "exact", "hierarchy",
           _N256 if n == 256 else None) for n in (4, 16, 64, 256)),
    Gate("hier_ingress_flatness", "hier_ingress_flatness", "<=", 1.6, "exact", "hierarchy"),
    Gate("hier_round_ratio_64_over_16", "hier_round_ratio_64_over_16", "<=", 12.0, "timed", "hierarchy"),
    Gate("hier_round_ratio_256_over_64", _N256, "<=", 4.0, "timed", "hierarchy", _N256),
    Gate("hier_root_egress_frac_256", "hier_root_egress_frac_256", "<=", 8.0, "exact", "hierarchy", _N256),
    Gate("hier_chaos_fallbacks", "hier_chaos_fallbacks", "==", 0, "exact", "hierarchy", _N256),
    Gate("hier_chaos_agree", "hier_chaos_agree", "is", True, "exact", "hierarchy", _N256),
    Gate("hier_chaos_cutoffs", "hier_chaos_cutoffs", ">=", 1, "exact", "hierarchy", _N256),
    Gate("coord_bytes_in_frac", "coord_bytes_in_frac", "<=", 0.4, "exact", "ring_agg"),
    Gate("overlap_hidden_comm_frac", "overlap_hidden_comm_frac", ">=", 0.5, "timed", "overlap"),
    Gate("wire_vs_push_capability", "wire_vs_push_capability", ">=", 0.5, "timed", "send_path"),
    Gate("send_vs_read_wall_ratio", "send_vs_read_wall_ratio", "<=", 1.5, "timed", "send_path"),
    Gate("local_link_vs_wire", "local_link_vs_wire", ">=", 2.0, "timed", "send_path"),
    Gate("local_link_backend", "local_link_backend", "==", "shm", "exact", "send_path"),
    Gate("chaos_rounds_completed", "chaos_rounds_completed", "==", CHAOSB_ROUNDS, "exact", "chaos"),
    Gate("chaos_survivors", "chaos_survivors", "==", len(CHAOSB_PARTIES) - 2, "exact", "chaos"),
    Gate("chaos_final_consistent", "chaos_final_consistent", "true", None, "exact", "chaos"),
    Gate("chaos_round1_strict_subset", "chaos_round1_members", "len_in", (2, len(CHAOSB_PARTIES)), "exact", "chaos"),
    Gate("chaos_roster_epoch", "chaos_roster_epoch", ">=", 2, "exact", "chaos"),
    Gate("chaos_coordinator_failovers", "chaos_coordinator_failovers", ">=", 1, "exact", "chaos"),
    Gate("trace_overhead_frac", "trace_overhead_frac", "<=", 0.03, "timed", "telemetry"),
    Gate("trace_critical_path_agrees", "trace_critical_path_agrees", "true", None, "exact", "telemetry"),
    Gate("async_tt_frac", "async_tt_frac", "<=", 0.8, "timed", "async_rounds"),
    Gate("async_refold_bitexact", "async_refold_bitexact", "true", None, "exact", "async_rounds"),
    Gate("async_versions_per_sec", "async_versions_per_sec", ">=", 1.0, "timed", "async_rounds"),
)


def gate_passes(gate: Gate, extra: dict) -> Optional[bool]:
    """The gate's verdict on ``extra``: None when it does not apply (its
    ``requires`` key is absent), else whether the value is present and
    holds."""
    if gate.requires is not None and gate.requires not in extra:
        return None
    value = extra.get(gate.key)
    if value is None:
        return False
    try:
        return bool(_OPS[gate.op](value, gate.threshold))
    except TypeError:
        return False


def failed_gates(extra: dict, legs=LEG_NAMES) -> List[str]:
    """Every leg error of ``legs`` and every gate of theirs that misses."""
    failed = [f"{name}_error" for name in legs if f"{name}_error" in extra]
    for gate in GATES:
        if gate.leg in legs and gate_passes(gate, extra) is False:
            failed.append(gate.name)
    return failed


def _check_device(device: str) -> None:
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_torch: no CUDA device is available; pass --device cpu to run on the CPU")


def run_leg(name: str, device: str = "cuda", stats: Optional[dict] = None) -> dict:
    """Run one smoke leg on ``device`` and return its keys (with
    ``{name}_error`` when it failed).  ``stats``, when given, gets
    ``stats[name] = {"s": wall, "launches": {kernel: n}}``: the leg's wall,
    its processes' start included, and its children's kernel launches."""
    _check_device(device)
    (msg, runner), = [(m, r) for n, m, r in LEGS if n == name]
    extra: dict = {}
    launches: collections.Counter = collections.Counter()
    before = os.environ.get("RAYFED_BENCH_SMOKE")
    os.environ["RAYFED_BENCH_SMOKE"] = "1"  # the children inherit it
    t0 = time.perf_counter()
    try:
        with _section(extra, name):
            _log(f"{msg} on {device}...")
            runner(device, extra, launches)
    finally:
        wall = time.perf_counter() - t0
        if before is None:
            del os.environ["RAYFED_BENCH_SMOKE"]
        else:
            os.environ["RAYFED_BENCH_SMOKE"] = before
    _log(f"  {name}: {wall:.1f} s")
    if stats is not None:
        stats[name] = {"s": wall, "launches": dict(launches)}
    return extra


def run_smoke(device: str = "cuda", legs=LEG_NAMES, stats: Optional[dict] = None,
              lanes: int = 1) -> Tuple[dict, List[str]]:
    """Every smoke leg of ``legs`` on ``device``, in bench.py's order.
    Returns the record bench.py --smoke prints and the names of the failed
    legs and missed gates; ``stats`` as ``run_leg``'s.  Raises before any
    leg when the card is asked for and there is none.

    ``lanes`` > 1 runs that many legs at once: each lane takes the next leg
    in order when its last one has ended.  The legs share no port, socket
    path or process, and the record is merged in bench.py's order, so only
    the timed gates change: their walls then share the host's cores."""
    _check_device(device)
    by_leg: dict = {}
    if lanes == 1:
        for name in legs:
            by_leg[name] = run_leg(name, device, stats)
    else:
        # Set for the whole pool: a lane's run_leg restores what it found,
        # and must not take the flag from under another lane's children.
        before = os.environ.get("RAYFED_BENCH_SMOKE")
        os.environ["RAYFED_BENCH_SMOKE"] = "1"
        try:
            with concurrent.futures.ThreadPoolExecutor(lanes) as pool:
                by_leg = dict(zip(legs, pool.map(lambda name: run_leg(name, device, stats), legs)))
        finally:
            if before is None:
                del os.environ["RAYFED_BENCH_SMOKE"]
            else:
                os.environ["RAYFED_BENCH_SMOKE"] = before
    extra: dict = {}
    for name in legs:
        extra.update(by_leg[name])
    record = {
        "metric": "cross_party_stream_agg_GBps",
        "value": extra.get("cross_party_stream_agg_GBps", 0.0),
        "unit": "GB/s",
        "vs_baseline": 1.0,
        "smoke": True,
    }
    record.update(extra)
    return record, failed_gates(extra, legs)


# --------------------------------------------------------------------------
# The compute section: bench.py's accelerator legs, in this process
# --------------------------------------------------------------------------

# Peak dense bf16 FLOP/s and HBM bytes/s by device name: NVIDIA's data sheet
# of the H100 SXM part, the card that names itself "NVIDIA H100 80GB HBM3".
# A card missing here raises: a share of an invented peak is no number.
_PEAK_FLOPS = {"H100 80GB HBM3": 989e12}
_PEAK_HBM_BPS = {"H100 80GB HBM3": 3.35e12}


def _device_kind(device) -> str:
    """``"cpu"``, or the CUDA card's name (``torch.cuda.get_device_name``)."""
    dev = torch.device(device)
    return "cpu" if dev.type == "cpu" else torch.cuda.get_device_name(dev)


def _peak_lookup(table: dict, fallback: float, kind: str) -> float:
    """The peak of device ``kind`` in ``table``; the host (``"cpu"``) takes
    the reference's indicative ``fallback``."""
    if kind == "cpu":
        return fallback
    for name, peak in table.items():
        if name.lower() in kind.lower():
            return peak
    raise RuntimeError(f"bench_torch: no published peak for {kind!r}")


def _peak_flops(kind: str) -> float:
    return _peak_lookup(_PEAK_FLOPS, 1e12, kind)  # CPU figure; MFU indicative


def _peak_hbm_bps(kind: str) -> float:
    return _peak_lookup(_PEAK_HBM_BPS, 100e9, kind)


def _gen(device, seed: int) -> torch.Generator:
    """A generator on ``device`` seeded as the reference's ``PRNGKey(seed)``
    (other numbers than ``jax.random``'s)."""
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def _bench_llama_config(**kw):
    """bench.py's ~1.07B Llama: vocab 16384, d 2048, 16 layers, 16 heads
    over 8 KV heads, ffn 8192, bf16 params and activations."""
    from rayfed_tpu_torch.models import llama

    return llama.LlamaConfig(
        vocab_size=16384, hidden_size=2048, num_layers=16, num_heads=16, num_kv_heads=8,
        intermediate_size=8192, max_seq_len=2048, dtype=torch.bfloat16, param_dtype=torch.bfloat16,
        **kw,
    )


def _meta_params(cfg):
    """``cfg``'s param tree on the meta device: shapes and dtypes, no storage
    (the reference's ``jax.eval_shape``)."""
    from rayfed_tpu_torch.models import llama

    return llama.init_llama(cfg, None, device="meta")


def _llama_step_flops(cfg, batch: int, seq: int, n_matmul: int) -> int:
    """Model FLOPs of a train step: 6 * matmul-params * tokens (fwd 2NT +
    bwd 4NT; the embedding gather does none, the lm_head does) plus causal
    attention 6 * L*B*T^2*d (12 * L*B*T^2*d full, halved for causal)."""
    return 6 * n_matmul * batch * seq + 6 * cfg.num_layers * batch * seq**2 * cfg.hidden_size


def _layer_matmul_flops(cfg, batch: int, seq: int) -> int:
    """Counted fwd+bwd FLOPs of one layer's matmuls (q/k/v/o and the SwiGLU
    FFN): the yardstick of the breakdown's matmul line."""
    d, h, dh, f = cfg.hidden_size, cfg.num_heads, cfg.head_dim, cfg.intermediate_size
    kv_dim = cfg.num_kv_heads * dh
    return 6 * (d * h * dh + 2 * d * kv_dim + h * dh * d + 3 * d * f) * batch * seq


def _flash_counts() -> Dict[str, int]:
    return {k: v for k, v in _launches().items() if k.startswith("flash_")}


def _train_slope(device, make_loop, fresh, args, n_short: int, n_long: int, stats: dict) -> float:
    """Seconds per step of ``make_loop(n)(*fresh(), *args)`` by slope between
    ``n_short`` and ``n_long`` steps, each length run once warm and once
    timed from fresh state (the loops update it in place, as the
    reference's donate it).  ``stats`` gets the steps run and their flash
    launches."""
    before, steps = _flash_counts(), 0

    def timed_run(n: int) -> float:
        nonlocal steps
        loop = make_loop(n)
        float(loop(*fresh(), *args)[2][-1])  # warm
        state = fresh()
        _sync(device)
        t0 = time.perf_counter()
        final = float(loop(*state, *args)[2][-1])
        wall = time.perf_counter() - t0
        assert final == final, "loss is NaN"
        steps += 2 * n
        return wall

    t_short = timed_run(n_short)
    t_long = timed_run(n_long)
    after = _flash_counts()
    stats["train_steps"] = steps
    stats["train_launches"] = {k: after[k] - before[k] for k in after}
    return max((t_long - t_short) / (n_long - n_short), 1e-9)


def bench_llama(device, *, cfg=None, batch: int = 2, seq: int = 2048, n_short: int = 2, n_long: int = 12,
                probe_n: Optional[dict] = None, stats: Optional[dict] = None) -> dict:
    """Full-param Adam training of the ~1.07B Llama, bf16, flash attention
    and ``remat_policy="dots"`` (bench.py's ``bench_llama``).

    The step time is the slope between ``n_short`` and ``n_long`` steps of
    ``make_train_loop`` (N step calls here, one compiled scan there), from
    fresh params and Adam state before every run; the MFU counts the
    reference's model FLOPs over the card's peak.  Adds the breakdown
    (:func:`_llama_mfu_breakdown`, ``probe_n`` its counts).
    """
    from rayfed_tpu_torch.models import llama
    from rayfed_tpu_torch.ops.flash_attention import flash_attention

    cfg = cfg or _bench_llama_config(remat=True, remat_policy="dots")
    stats = {} if stats is None else stats
    ids = torch.randint(0, cfg.vocab_size, (batch, seq), generator=_gen(device, 1), device=device)

    def fresh():
        params = llama.init_llama(cfg, _gen(device, 0), device=device)
        return params, llama.init_adam(params)

    def make_loop(n):
        return llama.make_train_loop(cfg, n, attn_fn=flash_attention, donate=True)

    _log("  llama train loops (short+long)...")
    step_time = _train_slope(device, make_loop, fresh, (ids,), n_short, n_long, stats)
    tokens = batch * seq
    meta = _meta_params(cfg)
    flops_per_step = _llama_step_flops(cfg, batch, seq, llama.param_count(meta, exclude_embed=True))
    out = {
        "llama_tokens_per_sec": round(tokens / step_time, 1),
        "llama_mfu": round(flops_per_step / step_time / _peak_flops(_device_kind(device)), 4),
        "llama_params_millions": round(llama.param_count(meta) / 1e6, 1),
        "llama_step_ms": round(step_time * 1e3, 2),
    }
    out.update(_llama_mfu_breakdown(cfg, batch, seq, step_time, device, probe_n=probe_n))
    return out


# (n_short, n_long) of each breakdown probe: the reference's counts.
PROBE_N = {"attn": (8, 2048), "matmul": (4, 256), "head": (4, 512), "adam": (4, 48), "norms_rope": (4, 256),
           "remat": (4, 64)}


def _llama_mfu_breakdown(cfg, batch, seq, step_time, device, *, probe_n: Optional[dict] = None) -> dict:
    """Where the train step's time goes (bench.py's ``_llama_mfu_breakdown``).

    Each component is probed alone at the step's exact shapes, slope-timed
    (``probe_n``, default :data:`PROBE_N`) and scaled by the layer count:
    the flash core (fwd+bwd), the layer matmuls (fwd+bwd), the lm_head
    (fwd+bwd, the port's: the final norm and an f32 product of upcast
    operands), the whole-tree Adam update (in place, as the step's), the
    norms and RoPE (fwd+bwd), and the remat recompute.  The reference
    charges that last one a whole layer forward a layer, since its
    backward replays the layer; the port's ``"dots"`` keeps every weight
    product (``aten.mm``), so its backward replays the rest of the forward
    (norms, RoPE, the flash forward, the SwiGLU elementwise, the
    residuals): the probe is a layer's forward less its seven weight
    products.  ``llama_other_ms`` is the step less the probes (embedding,
    loss, the replay's bookkeeping, Python and launch gaps), clamped at 0
    as the reference's.
    """
    from rayfed_tpu_torch.models import llama
    from rayfed_tpu_torch.ops.flash_attention import flash_attention

    counts = {**PROBE_N, **(probe_n or {})}
    B, T, D, L = batch, seq, cfg.hidden_size, cfg.num_layers
    H, Dh, F, V, KV = cfg.num_heads, cfg.head_dim, cfg.intermediate_size, cfg.vocab_size, cfg.num_kv_heads
    dt = cfg.dtype
    gen = _gen(device, 7)

    def normal(*shape, grad=False):
        x = (torch.randn(shape, generator=gen, device=device) * 0.02).to(dt)
        return x.requires_grad_(grad)

    def mk_x():
        return normal(B, T, D)

    def slope(name, body, make_init):
        """Per-iteration seconds of ``c = body(c)``, from a fresh carry per run."""
        n_short, n_long = counts[name]

        def run(n):
            def once():
                c = make_init()
                _sync(device)
                t0 = time.perf_counter()
                for _ in range(n):
                    c = body(c)
                float(pytree.tree_leaves(c)[0].float().sum())
                return time.perf_counter() - t0

            once()  # warm
            return once()

        t_s = run(n_short)
        t_l = run(n_long)
        return max((t_l - t_s) / (n_long - n_short), 0.0)

    def grads(loss_fn, *inputs):
        x = inputs[0].detach().requires_grad_(True)
        return torch.autograd.grad(loss_fn(x), (x, *inputs[1:]))

    def sq(t):
        return (t.float() ** 2).sum()

    # 1. The flash core, one layer (fwd+bwd: dQ and dK/dV), x L.
    k_attn, v_attn = normal(B, T, H, Dh, grad=True), normal(B, T, H, Dh, grad=True)

    def attn_body(q):
        return grads(lambda q: sq(flash_attention(q, k_attn, v_attn, causal=True)), q, k_attn, v_attn)[0].to(dt)

    attn_s = slope("attn", attn_body, lambda: normal(B, T, H, Dh)) * L

    # 2. Layer matmuls: q/k/v/o projections and the SwiGLU FFN, x L.
    kv_dim = KV * Dh
    w = {
        "wq": normal(D, H * Dh, grad=True), "wk": normal(D, kv_dim, grad=True),
        "wv": normal(D, kv_dim, grad=True), "wo": normal(H * Dh, D, grad=True),
        "w1": normal(D, F, grad=True), "w3": normal(D, F, grad=True), "w2": normal(F, D, grad=True),
    }

    def matmul_loss(x):
        o = (x @ w["wq"]) @ w["wo"]
        mlp = (torch.nn.functional.silu(x @ w["w1"]) * (x @ w["w3"])) @ w["w2"]
        return sq(o) + sq(mlp) + sq(x @ w["wk"]) + sq(x @ w["wv"])

    matmul_s = slope("matmul", lambda x: grads(matmul_loss, x, *w.values())[0].to(dt), mk_x) * L

    # 3. lm_head (fwd+bwd) as the step computes it: the final norm and the
    # product of f32-upcast operands (llama._lm_head).
    head = {"final_norm": torch.ones(D, dtype=dt, device=device).requires_grad_(True),
            "lm_head": normal(D, V, grad=True)}

    def head_body(x):
        return grads(lambda x: sq(llama._lm_head(x, head, cfg)), x, *head.values())[0].to(dt)

    head_s = slope("head", head_body, mk_x)

    # 4. The whole-tree Adam update, in place as the donated train step's.
    def mk_adam():
        params = llama.init_llama(cfg, _gen(device, 0), device=device)
        return params, llama.init_adam(params)

    def adam_body(c):
        p, o = c
        return llama._adam_update(p, p, o, 1e-4, 0.9, 0.999, 1e-8, inplace=True)

    adam_s = slope("adam", adam_body, mk_adam)

    # 5. Norms + RoPE (fwd+bwd), x L.
    g_norm1 = torch.ones(D, dtype=dt, device=device)
    g_norm2 = torch.ones(D, dtype=dt, device=device)
    cos_t, sin_t = llama.rope_tables(torch.arange(T, device=device), Dh, cfg.rope_theta)

    def norms_rope_loss(x):
        a = llama._rms_norm(x, g_norm1, cfg.rms_eps)
        b2 = llama._rms_norm(x, g_norm2, cfg.rms_eps)
        q = llama.apply_rope(x.reshape(B, T, H, Dh), cos_t, sin_t)
        k = llama.apply_rope(x[..., : KV * Dh].reshape(B, T, KV, Dh), cos_t, sin_t)
        return sq(a) + sq(b2) + sq(q) + sq(k)

    norms_s = slope("norms_rope", lambda x: grads(norms_rope_loss, x)[0].to(dt), mk_x) * L

    # 6. The remat recompute, x L: what the backward replays of a layer's
    # forward.  Under "dots" the weight products are kept, so the replay is
    # the forward less its seven products; without a policy, all of it.
    lp = {"attn_norm": g_norm1, "mlp_norm": g_norm2, "wq": w["wq"], "wk": w["wk"], "wv": w["wv"],
          "wo": w["wo"], "w_gate": w["w1"], "w_up": w["w3"], "w_down": w["w2"]}

    @torch.no_grad()
    def layer_fwd(x):
        return llama._layer_fwd(x, lp, cfg, cos_t, sin_t, flash_attention, B, T)[0]

    @torch.no_grad()
    def weight_products(x):
        q, _, _, gate, _ = (x @ w[name] for name in ("wq", "wk", "wv", "w1", "w3"))
        return q @ w["wo"] + gate @ w["w2"]

    remat_s = 0.0
    if cfg.remat:
        remat_s = slope("remat", layer_fwd, mk_x)
        if cfg.remat_policy == "dots":
            remat_s = max(remat_s - slope("remat", weight_products, mk_x), 0.0)
        remat_s *= L

    other_s = max(step_time - attn_s - matmul_s - head_s - adam_s - norms_s - remat_s, 0.0)
    lines = (("attention core (flash, fwd+bwd)", attn_s), ("layer matmuls (qkv/o + ffn)", matmul_s),
             ("lm_head", head_s), ("adam update", adam_s), ("norms + rope (fwd+bwd)", norms_s),
             ("remat recompute (x L)", remat_s), ("other (embed, loss, gaps)", other_s))
    _log("  mfu breakdown (probes, per step):\n" + "\n".join(
        f"    {name:34s}{s * 1e3:9.1f} ms ({s / step_time:5.1%})" for name, s in lines))
    layer_peak_ms = _layer_matmul_flops(cfg, B, T) / _peak_flops(_device_kind(device)) * 1e3
    if matmul_s > 0:
        _log(f"  layer matmuls {matmul_s / L * 1e3:.2f} ms/layer vs {layer_peak_ms:.2f} ms of counted FLOPs "
             f"at peak ({layer_peak_ms / (matmul_s / L * 1e3):.0%})")
    return {
        "llama_attn_ms": round(attn_s * 1e3, 1),
        "llama_matmul_ms": round(matmul_s * 1e3, 1),
        "llama_head_ms": round(head_s * 1e3, 1),
        "llama_adam_ms": round(adam_s * 1e3, 1),
        "llama_norms_rope_ms": round(norms_s * 1e3, 1),
        "llama_remat_ms": round(remat_s * 1e3, 1),
        "llama_other_ms": round(other_s * 1e3, 1),
    }


def _live_eff_len(t0: int, n_short: int, n_long: int) -> float:
    """Mean cache slots a decode step reads, over the steps the long
    generation adds to the short one.

    ``generate`` runs ``n_new - 1`` decode steps (the last token's logits
    are never read), and the step at position ``p`` reads the live prefix
    ``[0, p]``: ``p + 1`` slots, for ``p = t0 .. t0 + n_new - 2``.  (The
    reference's step reads the whole ``t0 + n_new`` buffer ``n_new``
    times, so its ``eff_len`` is ``t0 + n_short + n_long``.)
    """
    def reads(n_new: int) -> int:
        return sum(t0 + i + 1 for i in range(n_new - 1))

    return (reads(n_long) - reads(n_short)) / (n_long - n_short)


def _decode_slope(cfg, params, prompt, n_short, n_long, attn_fn, reps=3):
    """Steady-state decode seconds a token by slope between two generation
    lengths (the same prompt and prefill in both, so the delta is pure
    decode), median of ``reps``.  Returns ``(per_tok, eff_len)`` with
    :func:`_live_eff_len`'s cache extent."""
    from rayfed_tpu_torch.models import llama

    def timed(n_new):
        int(llama.greedy_generate(params, cfg, prompt, n_new, attn_fn=attn_fn).sum())  # warm
        vals = []
        for _ in range(reps):
            t = time.perf_counter()
            int(llama.greedy_generate(params, cfg, prompt, n_new, attn_fn=attn_fn).sum())
            vals.append(time.perf_counter() - t)
        return sorted(vals)[len(vals) // 2]

    per_tok = max((timed(n_long) - timed(n_short)) / (n_long - n_short), 1e-9)
    return per_tok, _live_eff_len(prompt.shape[1], n_short, n_long)


def _kv_cache_bytes(cfg, batch, eff_len):
    """Bytes of live KV cache read per decode step.

    Derived from ``cfg.kv_quant``: bf16 is 2 bytes/element; int8 is 1 byte
    plus the f32 per-(position, head) scale amortized over the head dim.
    """
    per_elem = (1 + 4 / cfg.head_dim) if cfg.kv_quant else 2
    return int(
        2 * cfg.num_layers * batch * eff_len
        * cfg.num_kv_heads * cfg.head_dim * per_elem
    )


def bench_decode(device, *, cfg=None, batch: int = 8, t0: int = 128, n_short: int = 16, n_long: int = 528,
                 t0_long: int = 1536, n_short_long: int = 16, n_long_long: int = 272, reps: int = 3,
                 stats: Optional[dict] = None) -> dict:
    """KV-cache greedy decode of the ~1.07B Llama (bench.py's
    ``bench_decode``): bf16, int8 weights (``quantize_llama_base``), and at
    ``t0_long`` bf16, int8 weights, and int8 weights with the int8 KV
    cache.  Flash prefill, slope timing.  Each ``*_membw_util`` is the
    bytes a step must read (every param once and the live cache) over the
    card's HBM rate; the f32 upcast of the cache is the port's own traffic,
    not counted."""
    from rayfed_tpu_torch.models import llama
    from rayfed_tpu_torch.models.quant import tree_nbytes
    from rayfed_tpu_torch.ops.flash_attention import flash_attention

    cfg = cfg or _bench_llama_config()
    stats = {} if stats is None else stats
    peak = _peak_hbm_bps(_device_kind(device))
    params = llama.init_llama(cfg, _gen(device, 0), device=device)
    prompt = torch.randint(0, cfg.vocab_size, (batch, t0), generator=_gen(device, 1), device=device)

    _log("  decode generations (short+long)...")
    per_tok, eff_len = _decode_slope(cfg, params, prompt, n_short, n_long, flash_attention, reps)
    _log("  int8 decode generations (short+long)...")
    qparams = llama.quantize_llama_base(params)
    per_tok_q, _ = _decode_slope(cfg, qparams, prompt, n_short, n_long, flash_attention, reps)
    param_bytes, qparam_bytes = tree_nbytes(params), tree_nbytes(qparams)
    kv_bytes = _kv_cache_bytes(cfg, batch, eff_len)
    membw_util = (param_bytes + kv_bytes) / per_tok / peak
    membw_util_q = (qparam_bytes + kv_bytes) / per_tok_q / peak
    weight_frac_q = qparam_bytes / peak / per_tok_q
    out = {
        "decode_tokens_per_sec": round(batch / per_tok, 1),
        "decode_step_ms": round(per_tok * 1e3, 2),
        "decode_membw_util": round(membw_util, 4),
        "decode_int8_tokens_per_sec": round(batch / per_tok_q, 1),
        "decode_int8_step_ms": round(per_tok_q * 1e3, 2),
        "decode_int8_membw_util": round(membw_util_q, 4),
        "decode_int8_weight_read_frac": round(weight_frac_q, 3),
        "decode_int8_speedup": round(per_tok / per_tok_q, 3),
    }

    _log("  long-context decode (bf16, int8 weights, int8 weights + kv)...")
    prompt_long = torch.randint(0, cfg.vocab_size, (batch, t0_long), generator=_gen(device, 2), device=device)
    per_tok_l, eff_len_l = _decode_slope(cfg, params, prompt_long, n_short_long, n_long_long, flash_attention, reps)
    per_tok_lw, _ = _decode_slope(cfg, qparams, prompt_long, n_short_long, n_long_long, flash_attention, reps)
    cfg_q = dataclasses.replace(cfg, kv_quant=True)
    per_tok_lq, _ = _decode_slope(cfg_q, qparams, prompt_long, n_short_long, n_long_long, flash_attention, reps)
    util_l = (param_bytes + _kv_cache_bytes(cfg, batch, eff_len_l)) / per_tok_l / peak
    util_lq = (qparam_bytes + _kv_cache_bytes(cfg_q, batch, eff_len_l)) / per_tok_lq / peak
    out.update(
        decode_long_tokens_per_sec=round(batch / per_tok_l, 1),
        decode_long_membw_util=round(util_l, 4),
        decode_long_int8w_tokens_per_sec=round(batch / per_tok_lw, 1),
        decode_long_int8_tokens_per_sec=round(batch / per_tok_lq, 1),
        decode_long_int8_membw_util=round(util_lq, 4),
        decode_long_int8_speedup=round(per_tok_l / per_tok_lq, 3),
        decode_long_kv_quant_speedup=round(per_tok_lw / per_tok_lq, 3),
    )
    stats.update(eff_len=eff_len, eff_len_long=eff_len_l, param_bytes=param_bytes, qparam_bytes=qparam_bytes)
    return out


def _grad_chain_slope(device, step, init, n_short, n_long, reps):
    """Median of ``reps`` slopes of ``c = step(c)`` chains between
    ``n_short`` and ``n_long`` iterations, each length run warm once first.
    ``step`` feeds its gradients back into its inputs, so every call does
    its work.  Returns ``(median, slopes)``."""
    def once(n):
        c = init()
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(n):
            c = step(c)
        float(pytree.tree_leaves(c)[0].float().sum())
        return time.perf_counter() - t0

    once(n_short)  # warm
    once(n_long)
    slopes = sorted((once(n_long) - once(n_short)) / (n_long - n_short) for _ in range(reps))
    return max(slopes[len(slopes) // 2], 1e-9), slopes


def bench_flash(device, *, heads: int = 16, head_dim: int = 64, batch: int = 4, seq: int = 2048,
                batch_long: int = 2, seq_long: int = 4096, n_short: int = 4, n_long: int = 64,
                n_long_t4096: int = 32, window: int = 1024, reps: int = 3, stats: Optional[dict] = None) -> dict:
    """Flash vs dense attention, causal fwd+bwd chains, bf16 BTHD (bench.py's
    ``bench_flash``): ``[batch, seq]`` and ``[batch_long, seq_long]``, and the
    sliding ``window`` at ``seq_long``; each iteration steps q, k and v by
    ``1e-6`` times their gradients.  The dense arm is the port's
    ``dot_product_attention`` (f32 scores)."""
    from rayfed_tpu_torch.ops.attention import dot_product_attention
    from rayfed_tpu_torch.ops.flash_attention import flash_attention

    stats = {} if stats is None else stats

    def timed(name, fn, args, n_long):
        def step(c):
            q, k, v = (t.detach().requires_grad_(True) for t in c)
            loss = (fn(q, k, v, causal=True).float() ** 2).sum()
            gq, gk, gv = torch.autograd.grad(loss, (q, k, v))
            return (c[0] - 1e-6 * gq, c[1] - 1e-6 * gk, c[2] - 1e-6 * gv)

        t, stats[name] = _grad_chain_slope(device, step, lambda: args, n_short, n_long, reps)
        return t

    def shape(b, t):
        gen = _gen(device, 0)
        return tuple(torch.randn((b, t, heads, head_dim), generator=gen, device=device).to(torch.bfloat16)
                     for _ in range(3))

    _log(f"  flash/dense attention chains (T={seq})...")
    args = shape(batch, seq)
    dense_t = timed("dense", dot_product_attention, args, n_long)
    flash_t = timed("flash", flash_attention, args, n_long)
    del args
    _log(f"  flash/dense attention chains (T={seq_long})...")
    args_l = shape(batch_long, seq_long)
    dense_l = timed("dense_long", dot_product_attention, args_l, n_long_t4096)
    flash_l = timed("flash_long", flash_attention, args_l, n_long_t4096)
    _log(f"  windowed flash chain (T={seq_long}, W={window})...")
    swa_l = timed("flash_window", functools.partial(flash_attention, window=window), args_l, n_long_t4096)
    return {
        "flash_speedup": round(dense_t / flash_t, 3),
        "flash_ms": round(flash_t * 1e3, 2),
        "dense_ms": round(dense_t * 1e3, 2),
        "flash_speedup_t4096": round(dense_l / flash_l, 3),
        "flash_ms_t4096": round(flash_l * 1e3, 2),
        "dense_ms_t4096": round(dense_l * 1e3, 2),
        "flash_window_ms_t4096": round(swa_l * 1e3, 2),
        "flash_window_speedup": round(flash_l / swa_l, 3),
    }


def bench_lora_8b(device, *, cfg=None, batch: int = 1, seq: int = 2048, rank: int = 16, n_short: int = 1,
                  n_long: int = 5, decode_batch: int = 4, prompt_len: int = 128, decode_short: int = 16,
                  decode_long: int = 272, reps: int = 3, stats: Optional[dict] = None) -> dict:
    """BASELINE.md #4 at full scale (bench.py's ``bench_lora_8b``):
    Llama-3-8B on an int8 base drawn directly as int8 on the device
    (``init_llama_int8``), rank-``rank`` adapters on ``w[qv]`` with Adam,
    full remat, flash attention, slope-timed; then int8 greedy decode over
    the same base."""
    from rayfed_tpu_torch.models import llama, lora
    from rayfed_tpu_torch.models.quant import tree_nbytes
    from rayfed_tpu_torch.ops.flash_attention import flash_attention

    cfg = cfg or llama.llama3_8b(max_seq_len=2048, dtype=torch.bfloat16, param_dtype=torch.bfloat16, remat=True)
    stats = {} if stats is None else stats
    base = llama.init_llama_int8(cfg, _gen(device, 0), device=device)
    lcfg = lora.LoraConfig(rank=rank, targets=(r"w[qv]$",))
    adapter_mb = tree_nbytes(lora.init_lora(base, lcfg, _gen(device, 1), device=device)) / 1e6
    ids = torch.randint(0, cfg.vocab_size, (batch, seq), generator=_gen(device, 2), device=device)

    def fresh():
        adapters = lora.init_lora(base, lcfg, _gen(device, 1), device=device)
        return adapters, llama.init_adam(adapters)

    def make_loop(n):
        return llama.make_lora_train_loop(cfg, n, attn_fn=flash_attention, donate=True)

    _log("  8B int8-base LoRA train loops (short+long)...")
    step_time = _train_slope(device, make_loop, fresh, (base, ids), n_short, n_long, stats)
    out = {
        "lora_8b_tokens_per_sec": round(batch * seq / step_time, 1),
        "lora_8b_step_ms": round(step_time * 1e3, 2),
        "lora_8b_params_b": round(llama.param_count(_meta_params(cfg)) / 1e9, 2),
        "lora_8b_base_gb": round(tree_nbytes(base) / 1e9, 2),
        "lora_8b_adapter_mb": round(adapter_mb, 2),
    }

    # 8B int8 serving over the resident base: each step reads the int8
    # weights and the live cache.
    _log("  8B int8 decode generations (short+long)...")
    prompt = torch.randint(0, cfg.vocab_size, (decode_batch, prompt_len), generator=_gen(device, 3), device=device)
    per_tok, eff_len = _decode_slope(cfg, base, prompt, decode_short, decode_long, flash_attention, reps)
    membw_util = (tree_nbytes(base) + _kv_cache_bytes(cfg, decode_batch, eff_len)) / per_tok \
        / _peak_hbm_bps(_device_kind(device))
    out.update(
        decode_8b_tokens_per_sec=round(decode_batch / per_tok, 1),
        decode_8b_step_ms=round(per_tok * 1e3, 2),
        decode_8b_membw_util=round(membw_util, 4),
    )
    stats["eff_len"] = eff_len
    return out


def bench_moe(device, *, cfg=None, batch: int = 1, seq: int = 4096, n_short: int = 2, n_long: int = 10,
              reps: int = 3, stats: Optional[dict] = None) -> dict:
    """Scatter vs one-hot-einsum MoE dispatch, fwd+bwd chains (bench.py's
    ``bench_moe``): E=16, top-2, d 1024, ffn 4096, bf16 params, x
    ``[batch, seq, d]``; each iteration steps the params by ``1e-6`` times
    their gradients."""
    from rayfed_tpu_torch.models import moe

    cfg = cfg or moe.MoeConfig(num_experts=16, top_k=2, d_model=1024, d_ff=4096, capacity_factor=1.25)
    stats = {} if stats is None else stats
    params = {k: v.to(torch.bfloat16) for k, v in moe.init_moe(cfg, _gen(device, 0), device=device).items()}
    x = torch.randn((batch, seq, cfg.d_model), generator=_gen(device, 1), device=device).to(torch.bfloat16)

    def timed(mode):
        def step(p):
            leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
            loss = (moe.apply_moe(leaves, x, cfg, dispatch=mode).float() ** 2).sum()
            grads = torch.autograd.grad(loss, tuple(leaves.values()))
            return {k: v - 1e-6 * g.to(v.dtype) for (k, v), g in zip(p.items(), grads)}

        t, stats[mode] = _grad_chain_slope(device, step, lambda: params, n_short, n_long, reps)
        return t

    _log(f"  moe scatter/einsum chains (T={seq}, E={cfg.num_experts})...")
    scatter_t = timed("scatter")
    einsum_t = timed("einsum")
    return {
        "moe_scatter_ms": round(scatter_t * 1e3, 2),
        "moe_einsum_ms": round(einsum_t * 1e3, 2),
        "moe_scatter_speedup": round(einsum_t / scatter_t, 3),
    }


# (section, what it runs, leg), in bench.py's compute order.
COMPUTE_LEGS = (
    ("llama_train", "1.07B Llama full-param Adam (B=2, T=2048, flash, remat dots) and its MFU breakdown",
     bench_llama),
    ("decode", "1.07B Llama KV-cache greedy decode (bf16, int8 weights, long context, int8 KV)", bench_decode),
    ("flash", "flash vs dense attention fwd+bwd chains (T=2048, T=4096, window 1024)", bench_flash),
    ("lora_8b", "Llama-3-8B int8-base LoRA step and 8B int8 decode", bench_lora_8b),
    ("moe", "MoE scatter vs einsum dispatch fwd+bwd (T=4096, E=16)", bench_moe),
)
COMPUTE_LEG_NAMES = tuple(name for name, _, _ in COMPUTE_LEGS)


def _env_keys(device) -> dict:
    """The reference's environment fingerprint, the device kind included."""
    import platform

    env: Dict[str, Any] = {"env_cpu_count": os.cpu_count()}
    try:
        env["env_loadavg_1m"] = round(os.getloadavg()[0], 2)
    except OSError:  # pragma: no cover
        env["env_loadavg_1m"] = None
    env["env_platform"] = platform.machine()
    env["env_device_kind"] = _device_kind(device)
    return env


def run_compute(device: str = "cuda", stats: Optional[dict] = None, legs=COMPUTE_LEG_NAMES,
                leg_kw: Optional[dict] = None) -> dict:
    """bench.py's compute section on ``device``, every leg of ``legs`` in its
    order in this process.  Returns the record ``bench.py --compute-only``
    prints (a failed leg's ``{leg}_error`` in it).  ``leg_kw[leg]`` are
    keyword arguments of that leg (sizes, counts; the reference's by
    default).  ``stats``, when given, gets ``stats[leg]``: the leg's wall
    ``s``, its kernel ``launches``, its ``peak_bytes`` on the card (None on
    the CPU) and what the leg recorded (the train legs' ``train_steps`` and
    ``train_launches``, the timed runs' slopes).  Raises before any leg when
    the card is asked for and there is none."""
    _check_device(device)
    on_card = torch.device(device).type == "cuda"
    extra = _env_keys(device)
    for name, msg, leg in COMPUTE_LEGS:
        if name not in legs:
            continue
        leg_stats: dict = {}
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        before = _launches()
        t0 = time.perf_counter()
        with _section(extra, name):
            _log(f"{msg} on {device}...")
            extra.update(leg(device, stats=leg_stats, **(leg_kw or {}).get(name, {})))
        _sync(device)
        wall = time.perf_counter() - t0
        after = _launches()
        leg_stats.update(s=wall, launches={k: after[k] - before[k] for k in after},
                         peak_bytes=torch.cuda.max_memory_allocated(device) if on_card else None)
        _log(f"  {name}: {wall:.1f} s, " + json.dumps({k: v for k, v in leg_stats.items() if k != "s"}))
        if stats is not None:
            stats[name] = leg_stats
        if on_card:
            torch.cuda.empty_cache()
    record = {
        "metric": "llama_tokens_per_sec",
        "value": extra.get("llama_tokens_per_sec", 0.0),
        "unit": "tokens/s",
        "vs_baseline": 1.0,
    }
    record.update(extra)
    # NaN is not valid JSON: null, as the reference's record.
    return {k: (None if isinstance(v, float) and v != v else v) for k, v in record.items()}


# --------------------------------------------------------------------------
# The federated section: bench.py's legs before its compute section
# --------------------------------------------------------------------------

# The headline's sizes (bench.py's N, D, CLASSES and round counts).
N, D, CLASSES = 1024, 784, 10
LOCAL_STEPS = 4
WARMUP_ROUNDS = 3
MEASURE_ROUNDS = 20
FED_PARTIES = ("alice", "bob")
RESNET_PARTIES = ("alice", "bob", "carol", "dave")
RESNET_N_PER_PARTY, RESNET_HW = 32, 32  # a CIFAR-10-shaped shard per party
RESNET_ROUNDS = 3
SETTLE_S = 3.0  # bench.py's _settle() between the federated legs
HEADLINE = "fedavg_mnist_2party_rounds_per_sec"


def _kw(kw: Optional[dict], name: str, default):
    return (kw or {}).get(name, default)


def _run_fedavg_party(party: str, result_q, device, cluster, kw: Optional[dict] = None) -> None:
    """BASELINE #2's headline (bench.py's leg): 2-party FedAvg of a
    logistic model over the real push transport, each party's trainer on
    ``device``; rounds/s over ``rounds`` rounds after ``warmup``."""
    import logging

    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch.fl import aggregate
    from rayfed_tpu_torch.models import logistic

    n, d, classes = _kw(kw, "n", N), _kw(kw, "d", D), _kw(kw, "classes", CLASSES)
    local_steps, warmup, rounds = _kw(kw, "local_steps", LOCAL_STEPS), _kw(kw, "warmup", WARMUP_ROUNDS), \
        _kw(kw, "rounds", MEASURE_ROUNDS)
    logging.disable(logging.WARNING)
    fed.init(address="local", cluster=cluster, party=party, device=device)

    @fed.remote
    class Trainer:
        def __init__(self, seed: int):
            self._x = torch.randn((n, d), generator=torch.Generator().manual_seed(seed)).to(device)
            w = torch.randn((d, classes), generator=torch.Generator().manual_seed(0)).to(device)
            self._y = torch.argmax(self._x @ w, dim=-1)
            self._step = logistic.make_train_step(logistic.apply_logistic, lr=0.2)

        def train(self, params):
            for _ in range(local_steps):
                params, _loss = self._step(params, self._x, self._y)
            _sync(device)
            return params

    alice = Trainer.party("alice").remote(1)
    bob = Trainer.party("bob").remote(2)
    params = logistic.init_logistic(d, classes, device=device)

    def do_round(params):
        return aggregate([alice.train.remote(params), bob.train.remote(params)])

    for _ in range(warmup):
        params = do_round(params)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(rounds):
        params = do_round(params)
    _sync(device)
    elapsed = time.perf_counter() - t0
    result_q.put((party, rounds / elapsed))
    fed.shutdown()


def _run_split_party(party: str, result_q, device, cluster, kw: Optional[dict] = None) -> None:
    """BASELINE #5's activation push (bench.py's leg): the pipelined split
    step (K microbatches' forwards pushed back to back) between two party
    processes, f32 and bf16 wire, best of three windows with the
    TransferLog's read/send decomposition; alice's serial compute probe of
    both halves gives the serialized ceiling."""
    import logging

    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch import metrics
    from rayfed_tpu_torch.fl import SplitTrainer
    from rayfed_tpu_torch.models.logistic import softmax_cross_entropy

    logging.disable(logging.WARNING)
    fed.init(address="local", cluster=cluster, party=party, device=device)
    n, d_in, d_hidden, classes, k_mb = (_kw(kw, "n", 4096), _kw(kw, "d_in", 16), _kw(kw, "d_hidden", 1024),
                                         _kw(kw, "classes", 10), _kw(kw, "k_mb", 8))

    def make_encoder_params():
        return {"k": torch.randn((d_in, d_hidden), generator=torch.Generator().manual_seed(0)).to(device) * 0.05}

    def make_head_params():
        return {"k": torch.randn((d_hidden, classes), generator=torch.Generator().manual_seed(1)).to(device) * 0.05}

    def make_x(mb):
        return torch.randn((n, d_in), generator=torch.Generator().manual_seed(70 + mb)).to(device)

    def make_y(mb):
        return torch.randint(0, classes, (n,), generator=torch.Generator().manual_seed(80 + mb)).to(device)

    def encoder_apply(params, x):
        return torch.relu(x @ params["k"])

    def head_apply(params, h):
        return h @ params["k"]

    def make_trainer(wire_dtype):
        return SplitTrainer(encoder_party="alice", head_party="bob", encoder_params=make_encoder_params(),
                            encoder_apply=encoder_apply, head_params=make_head_params(), head_apply=head_apply,
                            loss_fn=softmax_cross_entropy, lr=0.1, wire_dtype=wire_dtype)

    load_x, load_y = fed.remote(make_x), fed.remote(make_y)
    x_objs = [load_x.party("alice").remote(mb) for mb in range(k_mb)]
    y_objs = [load_y.party("bob").remote(mb) for mb in range(k_mb)]
    # A host of two cores or fewer takes the serialized step (K = 1), as
    # the reference does.
    k_mb_eff = k_mb if os.cpu_count() and os.cpu_count() > 2 else 1
    steps = _kw(kw, "steps", 8 if k_mb_eff > 1 else 24)
    windows = _kw(kw, "windows", 3)
    xs, ys = x_objs[:k_mb_eff], y_objs[:k_mb_eff]

    def timed(trainer):
        trainer.step_pipelined(xs, ys)  # warmup
        best = None
        for _w in range(windows):
            fed.get(trainer.encoder_params())  # every earlier step's traffic drained
            total0 = metrics.get_transfer_log().total_recorded
            t0 = time.perf_counter()
            for _ in range(steps):
                trainer.step_pipelined(xs, ys)
            fed.get(trainer.encoder_params())
            elapsed = time.perf_counter() - t0
            recs, complete = metrics.get_transfer_log().records_since(total0)
            if complete:
                read_s = sum(r.seconds for r in recs if r.direction == "recv")
                send_s = sum(r.seconds for r in recs if r.direction == "send")
            else:  # the ring evicted part of the window
                read_s = send_s = float("nan")
            key = (not complete, elapsed)
            if best is None or key < best[0]:
                best = (key, (elapsed, read_s, send_s))
        return best[1]

    def compute_probe_ms() -> float:
        """Alice alone: both halves' math back to back, as the actors do it
        (encoder forward and recompute-backward, head loss and grads)."""
        if party != "alice":
            return 0.0
        k_enc, k_head = make_encoder_params()["k"], make_head_params()["k"]
        x, y = make_x(0), make_y(0)
        h = encoder_apply({"k": k_enc}, x)
        g = torch.ones_like(h)

        def one_step():
            with torch.no_grad():
                encoder_apply({"k": k_enc}, x)
            p = k_enc.detach().requires_grad_(True)
            torch.autograd.grad(encoder_apply({"k": p}, x), p, g)
            ph, hh = k_head.detach().requires_grad_(True), h.detach().requires_grad_(True)
            torch.autograd.grad(softmax_cross_entropy(head_apply({"k": ph}, hh), y), (ph, hh))
            _sync(device)

        one_step()
        t0 = time.perf_counter()
        for _ in range(4):
            one_step()
        return (time.perf_counter() - t0) / 4 * 1e3

    probe_ms = compute_probe_ms() * k_mb_eff
    el_f32, read_f32, send_f32 = timed(make_trainer(None))
    el_bf16, _read, _send = timed(make_trainer(torch.bfloat16))
    bytes_per_step = 2 * k_mb_eff * n * d_hidden * 4  # K x (activations + their grads), f32
    result_q.put((party, {
        "gbps": steps * bytes_per_step / el_f32 / 1e9,
        "steps_per_sec": steps / el_f32,
        "bf16_steps_per_sec": steps / el_bf16,
        "wire_read_ms": read_f32 / steps * 1e3,
        "send_path_ms": send_f32 / steps * 1e3,
        "other_ms": max(el_f32 - read_f32 - send_f32, 0.0) / steps * 1e3,
        "compute_probe_ms": probe_ms,
    }))
    fed.shutdown()


def _run_push_bench(_party: str, result_q, device, kw: Optional[dict] = None) -> None:
    """The raw push path (bench.py's leg): a 128 MB f32 [8192, 4096] tensor
    on the sender's ``device`` pushed over loopback to a receiver that keeps
    host arrays (``push_GBps``) or puts them on its ``device``
    (``push_reshard_GBps``), best of three windows; one payload striped over
    4 rails against 1; a 64-leaf 45 MB f32 tree compressed to bf16 and
    pushed end to end, packed against per-leaf."""
    from rayfed_tpu_torch import tree_util
    from rayfed_tpu_torch.config import ClusterConfig, JobConfig, PartyConfig
    from rayfed_tpu_torch.fl import compression as fl_comp
    from rayfed_tpu_torch.transport.manager import TransportManager
    from rayfed_tpu_torch.utils.ports import free_loopback_ports

    rows, cols = _kw(kw, "rows", 8192), _kw(kw, "cols", 4096)
    steps, reshard_steps, reps = _kw(kw, "steps", 6), _kw(kw, "reshard_steps", 4), _kw(kw, "reps", 3)
    rail_steps, rail_reps = _kw(kw, "rail_steps", 3), _kw(kw, "rail_reps", 2)
    leaves, leaf_rows = _kw(kw, "leaves", 64), _kw(kw, "leaf_rows", 44)

    def pair(device_put_received, options=None):
        """A started sender and receiver on free loopback ports; ``options``:
        the sender's transport options (the receiver keeps the defaults)."""
        ports = free_loopback_ports(2)
        out = []
        for party in ("alice", "bob"):
            pcs = [{"address": f"127.0.0.1:{port}"} for port in ports]
            if options and party == "alice":
                pcs = [dict(pc, transport_options=options) for pc in pcs]
            cc = ClusterConfig(parties={p: PartyConfig.from_dict(pc) for p, pc in zip(("alice", "bob"), pcs)},
                               current_party=party)
            job = JobConfig(device_put_received=device_put_received, zero_copy_host_arrays=not device_put_received)
            out.append(TransportManager(cc, job, device=device))
        for m in out:
            m.start()
        return out

    x = torch.arange(rows * cols, dtype=torch.float32, device=device).reshape(rows, cols)
    _sync(device)
    nbytes = x.numel() * x.element_size()

    def run(device_put_received, n_steps):
        a, b = pair(device_put_received)
        a.send("bob", x, "warm", "0").resolve()
        b.recv("alice", "warm", "0").resolve()
        best_dt, seq = float("inf"), 0
        for _rep in range(reps):
            send_refs = []
            t0 = time.perf_counter()
            for _ in range(n_steps):
                send_refs.append(a.send("bob", x, f"p{seq}", "0"))
                got = b.recv("alice", f"p{seq}", "0").resolve()
                seq += 1
            _sync(device)
            dt = time.perf_counter() - t0
            results = [r.resolve(timeout=60) for r in send_refs]
            if not all(results):
                raise RuntimeError(f"push send failed: {results}")
            best_dt = min(best_dt, dt)
        where = got.device.type if isinstance(got, torch.Tensor) else "host"
        a.stop()
        b.stop()
        return nbytes * n_steps / best_dt / 1e9, where

    wire_gbps, wire_at = run(False, steps)
    reshard_gbps, reshard_at = run(True, reshard_steps)
    if torch.device(device).type == "cuda" and (wire_at == "cuda" or reshard_at != "cuda"):
        raise RuntimeError(f"push bench: host-array receive landed on {wire_at}, device receive on {reshard_at}")

    def run_rails(rails):
        # stripe_rails explicit: the host-adaptive default turns striping
        # off on few-core hosts, and this probe measures it.
        a, b = pair(False, {"connections_per_peer": rails, "stripe_rails": rails})
        a.send("bob", x, "warmr", "0").resolve()
        b.recv("alice", "warmr", "0").resolve()
        best_dt = float("inf")
        for rep in range(rail_reps):
            refs = []
            t0 = time.perf_counter()
            for i in range(rail_steps):
                refs.append(a.send("bob", x, f"mr{rep}-{i}", "0"))
                b.recv("alice", f"mr{rep}-{i}", "0").resolve()
            dt = time.perf_counter() - t0
            results = [r.resolve(timeout=60) for r in refs]
            if not all(results):
                raise RuntimeError(f"multirail push failed: {results}")
            best_dt = min(best_dt, dt)
        a.stop()
        b.stop()
        return nbytes * rail_steps / best_dt / 1e9

    multirail_gbps = run_rails(4)
    singlerail_gbps = run_rails(1)

    tree = {f"layer{i}": torch.arange(leaf_rows * 4096, dtype=torch.float32, device=device).reshape(leaf_rows, 4096)
            + i for i in range(leaves)}
    _sync(device)

    def run_tree(packed, n_steps=3, n_reps=2):
        a, b = pair(False)
        payload = fl_comp.compress(tree, packed=packed)
        wire_bytes = sum(leaf.numel() * leaf.element_size() for leaf in tree_util.tree_leaves(payload)
                         if isinstance(leaf, torch.Tensor))
        a.send("bob", payload, "warmt", "0").resolve()
        fl_comp.decompress(b.recv("alice", "warmt", "0").resolve(timeout=60))
        stats0 = a.get_stats()
        best_dt, seq = float("inf"), 0
        for _rep in range(n_reps):
            send_refs = []
            t0 = time.perf_counter()
            for _ in range(n_steps):
                payload = fl_comp.compress(tree, packed=packed)
                send_refs.append(a.send("bob", payload, f"t{seq}", "0"))
                fl_comp.decompress(b.recv("alice", f"t{seq}", "0").resolve(timeout=60))
                _sync(device)
                seq += 1
            dt = time.perf_counter() - t0
            results = [r.resolve(timeout=60) for r in send_refs]
            if not all(results):
                raise RuntimeError(f"tree push send failed: {results}")
            best_dt = min(best_dt, dt)
        stats1 = a.get_stats()
        stats = {k: stats1[k] - stats0[k] for k in ("send_prepare_s", "send_write_s", "send_frame_wall_s")}
        a.stop()
        b.stop()
        return wire_bytes * n_steps / best_dt / 1e9, stats

    packed_gbps, packed_stats = run_tree(True)
    perleaf_gbps, _stats = run_tree(False)
    busy = packed_stats["send_prepare_s"] + packed_stats["send_write_s"]
    saved = max(0.0, busy - packed_stats["send_frame_wall_s"])
    overlap_frac = saved / busy if busy > 0 else 0.0
    result_q.put(("push", (wire_gbps, reshard_gbps, packed_gbps, perleaf_gbps, overlap_frac, multirail_gbps,
                           singlerail_gbps)))


def _resnet_party_data(cfg, seed: int, device, batch: int = RESNET_N_PER_PARTY, hw: int = RESNET_HW):
    """A synthetic CIFAR-shaped shard (NHWC, as the reference's): one recipe
    for the FedAvg trainer, the in-process floor and the DP control."""
    x = torch.randn((batch, hw, hw, 3), generator=torch.Generator().manual_seed(seed))
    probe = torch.randn((3, cfg.num_classes), generator=torch.Generator().manual_seed(0))
    y = torch.argmax(x.mean(dim=(1, 2)) @ probe, dim=-1)
    return x.to(device), y.to(device)


def _cpu_seconds() -> float:
    """This process's consumed CPU time (user + sys)."""
    import resource

    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def _run_resnet_party(party: str, result_q, device, cluster, kw: Optional[dict] = None, barrier=None) -> None:
    """BASELINE #3 (bench.py's leg): 4-party ResNet-18 FedAvg over the real
    transport, pipelined rounds (``aggregate(..., materialize=False)``
    feeding the next round), packed bf16 bundles; in the same processes the
    contention floor (bare local rounds, barrier-synced) before and after
    the FedAvg window, and the decompression probe, packed against
    per-leaf."""
    import logging

    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch import metrics, tree_util
    from rayfed_tpu_torch.fl import aggregate
    from rayfed_tpu_torch.fl import compression as fl_comp
    from rayfed_tpu_torch.models import resnet
    from rayfed_tpu_torch.runtime import get_runtime_or_none

    logging.disable(logging.WARNING)
    fed.init(address="local", cluster=cluster, party=party, device=device)
    batch, hw = _kw(kw, "batch", RESNET_N_PER_PARTY), _kw(kw, "hw", RESNET_HW)
    rounds = _kw(kw, "rounds", RESNET_ROUNDS)
    cfg = resnet.resnet18(num_classes=10)
    phases: dict = {}
    fed_step = resnet.make_fed_train_step(cfg, lr=0.05)

    @fed.remote
    class Trainer:
        def __init__(self, seed: int):
            self._x, self._y = _resnet_party_data(cfg, seed, device, batch, hw)

        def train(self, bundle):
            t0 = time.perf_counter()
            out, loss = fed_step(bundle, self._x, self._y)
            _sync(device)
            phases["step_s"] = phases.get("step_s", 0.0) + time.perf_counter() - t0
            return out

    trainers = {p: Trainer.party(p).remote(i + 1) for i, p in enumerate(RESNET_PARTIES)}
    bundle = fl_comp.compress(resnet.init_resnet(torch.Generator().manual_seed(0), cfg, device=device), packed=True)
    bundle_bytes = sum(leaf.numel() * leaf.element_size() for leaf in tree_util.tree_leaves(bundle)
                       if isinstance(leaf, torch.Tensor))

    def do_round(bundle_or_obj):
        return aggregate([trainers[p].train.remote(bundle_or_obj) for p in RESNET_PARTIES], materialize=False)

    bundle = fed.get(do_round(bundle))  # warmup: the first full exchange
    _sync(device)

    def drain_sends():
        rt = get_runtime_or_none()
        cm = rt.cleanup_manager if rt is not None else None
        if cm is not None:
            cm.wait_sending()

    drain_sends()
    phases.clear()

    def floor_leg(seed_bundle, x_loc, y_loc):
        barrier.wait(timeout=300)
        fcpu0, ft0 = _cpu_seconds(), time.perf_counter()
        fb = seed_bundle
        for _ in range(rounds):
            fb, _floss = fed_step(fb, x_loc, y_loc)
            _sync(device)
            barrier.wait(timeout=300)
        return rounds / (time.perf_counter() - ft0), (_cpu_seconds() - fcpu0) / rounds

    floor_rps = floor_cpu = float("nan")
    if barrier is not None:
        x_loc, y_loc = _resnet_party_data(cfg, RESNET_PARTIES.index(party) + 1, device, batch, hw)
        fed_step(bundle, x_loc, y_loc)
        _sync(device)
        floor_pre = floor_leg(bundle, x_loc, y_loc)

    total0 = metrics.get_transfer_log().total_recorded
    cpu0 = _cpu_seconds()
    t0 = time.perf_counter()
    obj = do_round(bundle)
    for _ in range(rounds - 1):
        obj = do_round(obj)  # lazy: the rounds pipeline through the DAG
    bundle = fed.get(obj)
    _sync(device)
    elapsed = time.perf_counter() - t0
    cpu_s = _cpu_seconds() - cpu0
    drain_sends()

    if barrier is not None:
        floor_post = floor_leg(bundle, x_loc, y_loc)
        floor_rps = 2.0 / (1.0 / floor_pre[0] + 1.0 / floor_post[0])
        floor_cpu = (floor_pre[1] + floor_post[1]) / 2.0

    def probe(fn, reps=3):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            _sync(device)
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    decomp_packed_ms = probe(lambda: fl_comp.decompress(bundle, torch.float32))
    leaf_tree = fl_comp.unpack_tree(bundle)  # the per-leaf bf16 wire form
    decomp_perleaf_ms = probe(lambda: fl_comp.cast_floats(leaf_tree, torch.float32))

    recs, complete = metrics.get_transfer_log().records_since(total0)
    if complete:
        read_ms = sum(r.seconds for r in recs if r.direction == "recv") / rounds * 1e3
        send_ms = sum(r.seconds for r in recs if r.direction == "send") / rounds * 1e3
    else:  # the ring evicted part of the window
        read_ms = send_ms = float("nan")
    wire_bytes = 2 * (len(RESNET_PARTIES) - 1) * bundle_bytes * rounds  # the hub: N-1 in, N-1 out
    result_q.put((party, (rounds / elapsed, wire_bytes / elapsed / 1e9, read_ms, send_ms,
                          phases.get("step_s", 0.0) / rounds * 1e3, cpu_s / rounds, elapsed / rounds,
                          floor_rps, floor_cpu, decomp_packed_ms, decomp_perleaf_ms)))
    fed.shutdown()


def _resnet_solo_rounds_per_sec(device, batch: int, seed: int, hw: int, rounds: int):
    """The DP control's body: ResNet-18 on the same synthetic data at
    ``batch``, one warm step, then ``rounds`` timed steps.  Returns
    (rounds/s, CPU seconds a round)."""
    from rayfed_tpu_torch.models import resnet

    cfg = resnet.resnet18(num_classes=10)
    x, y = _resnet_party_data(cfg, seed, device, batch, hw)
    params, state = resnet.init_resnet(torch.Generator().manual_seed(0), cfg, device=device)
    opt = resnet.init_opt_state(params)
    step = resnet.make_train_step(cfg, lr=0.05)
    params, state, opt, loss = step(params, state, opt, x, y)
    _sync(device)
    cpu0 = _cpu_seconds()
    t0 = time.perf_counter()
    for _ in range(rounds):
        params, state, opt, loss = step(params, state, opt, x, y)
    _sync(device)
    elapsed = time.perf_counter() - t0
    return rounds / elapsed, (_cpu_seconds() - cpu0) / rounds


def _run_resnet_dp_control(_party: str, result_q, device, kw: Optional[dict] = None) -> None:
    """The north-star denominator (bench.py's leg): one process, ResNet-18
    at the parties' total batch (4 x 32)."""
    batch = _kw(kw, "batch", RESNET_N_PER_PARTY) * len(RESNET_PARTIES)
    result_q.put(("dp", _resnet_solo_rounds_per_sec(device, batch, 0, _kw(kw, "hw", RESNET_HW),
                                                     _kw(kw, "rounds", RESNET_ROUNDS))))


def _run_lora_party(party: str, result_q, device, cluster, kw: Optional[dict] = None) -> None:
    """BASELINE #4 (bench.py's leg): a 2-party Llama-LoRA fine-tune, each
    party training rank-8 adapters on ``w[qv]`` and ``lm_head`` over a
    frozen f32 base with the default dense attention, the adapters averaged
    each round; rounds/s and the adapter MB a push."""
    import logging

    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch import tree_util
    from rayfed_tpu_torch.fl import aggregate
    from rayfed_tpu_torch.models import llama, lora

    logging.disable(logging.WARNING)
    fed.init(address="local", cluster=cluster, party=party, device=device)
    cfg = llama.LlamaConfig(**{**LORA_CONFIG, **_kw(kw, "config", {})})
    lcfg = lora.LoraConfig(rank=8, targets=(r"w[qv]$", r"lm_head$"))
    seq, batch, rounds = _kw(kw, "seq", 128), _kw(kw, "batch", 4), _kw(kw, "rounds", 5)

    def base_params():
        return llama.init_llama(cfg, torch.Generator(device=torch.device(device)).manual_seed(42), device=device)

    @fed.remote
    class Tuner:
        def __init__(self, seed: int):
            self._base = base_params()
            self._ids = torch.randint(0, cfg.vocab_size, (batch, seq),
                                      generator=torch.Generator().manual_seed(seed)).to(device)
            self._step = llama.make_lora_train_step(cfg, lr=1e-3)

        def train(self, adapters):
            opt = llama.init_adam(adapters)
            adapters, opt, loss = self._step(adapters, opt, self._base, self._ids)
            _sync(device)
            return adapters

    tuners = {p: Tuner.party(p).remote(i + 10) for i, p in enumerate(FED_PARTIES)}
    adapters = lora.init_lora(base_params(), lcfg, torch.Generator(device=torch.device(device)).manual_seed(7),
                              device=device)
    adapter_bytes = sum(leaf.numel() * leaf.element_size() for leaf in tree_util.tree_leaves(adapters))

    def do_round(adapters):
        return aggregate([tuners[p].train.remote(adapters) for p in FED_PARTIES])

    adapters = do_round(adapters)  # warmup: the first exchange
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(rounds):
        adapters = do_round(adapters)
    _sync(device)
    elapsed = time.perf_counter() - t0
    result_q.put((party, (rounds / elapsed, adapter_bytes / 1e6)))
    fed.shutdown()


# The LoRA leg's Llama (bench.py's): f32, 4 layers of width 256.
LORA_CONFIG = dict(vocab_size=2048, hidden_size=256, num_layers=4, num_heads=8, num_kv_heads=4,
                   intermediate_size=1024, max_seq_len=256, dtype=torch.float32)


def _pp_world(rank: int, dev, kw: Optional[dict]) -> dict:
    """A rank of the pipeline leg (bench.py's ``_run_pp_vs_dp`` over a
    4-rank world): the 1F1B and interleaved (v=2) pipeline train steps of 8
    tanh layers of width 512 at B=64, M=8, against the DP step at equal
    params and batch (each rank a quarter of the batch, the gradients
    all-reduced), each the best of ``reps`` windows of ``n`` steps from a
    barrier.  Returns this rank's seconds a step, kernel launches and peak
    device memory."""
    import torch.distributed as dist

    from rayfed_tpu_torch.parallel import collectives as coll
    from rayfed_tpu_torch.parallel import pipeline as pp
    from rayfed_tpu_torch.parallel.mesh import create_mesh

    width, layers, batch, num_mb = (_kw(kw, "width", 512), _kw(kw, "layers", 8), _kw(kw, "batch", 64),
                                    _kw(kw, "num_mb", 8))
    n, reps = _kw(kw, "n", 4), _kw(kw, "reps", 3)
    world = dist.get_world_size()
    gen = torch.Generator().manual_seed(0)
    params = pp.stack_params([{"w": torch.randn((width, width), generator=gen) * width ** -0.5,
                               "b": torch.zeros(width)} for _ in range(layers)])
    params = {k: v.to(dev) for k, v in params.items()}
    x = torch.randn((batch, width), generator=torch.Generator().manual_seed(1)).to(dev)
    tgt = torch.randn((batch, width), generator=torch.Generator().manual_seed(2)).to(dev)

    def stage_fn(stage_params, h):
        for i in range(stage_params["w"].shape[0]):
            h = torch.tanh(h @ stage_params["w"][i] + stage_params["b"][i])
        return h

    def mse(y, t):
        return torch.mean((y - t) ** 2)

    def timed(step, args):
        step(*args)
        _sync(dev)
        best = float("inf")
        for _ in range(reps):
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(n):
                out = step(*args)
            _sync(dev)
            best = min(best, (time.perf_counter() - t0) / n)
        del out
        return best

    mesh = create_mesh({"pp": world}, device=dev.type)
    pp_t = timed(pp.make_pipeline_train(mesh, stage_fn, mse, num_microbatches=num_mb), (params, x, tgt))
    ppi_t = timed(pp.make_pipeline_train(mesh, stage_fn, mse, num_microbatches=num_mb, virtual_stages=2),
                  (params, x, tgt))
    shard = batch // world
    xs, ts = x[rank * shard:(rank + 1) * shard], tgt[rank * shard:(rank + 1) * shard]

    def dp_step(p, xs, ts):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        loss = mse(stage_fn(leaves, xs), ts)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        # The global batch's mean: the shards' means averaged.
        return (coll.all_reduce_sum(loss.detach(), None) / world,
                {k: coll.all_reduce_sum(g, None) / world for k, g in zip(leaves, grads)})

    dp_t = timed(dp_step, (params, xs, ts))
    _assert_no_jax()
    return {"pp": pp_t, "ppi": ppi_t, "dp": dp_t, "launches": _launches(), "peak": _peak_bytes()}


# -- the legs' runners and their keys, in bench.py's order ----------------

def _fed_leg_pp(device, extra, launches, peaks, kw):
    from rayfed_tpu_torch.parallel.launch import run_world

    on_card = torch.device(device).type == "cuda"
    ranks = run_world(_pp_world, 4, (kw,), device=None if on_card else device, timeout_s=_kw(kw, "timeout", 900))
    for r in ranks:
        launches.update(r["launches"])
        if r["peak"] is not None:
            peaks.append(r["peak"])
    # The slowest rank's window is the step's.
    pp_t, ppi_t, dp_t = (max(r[k] for r in ranks) for k in ("pp", "ppi", "dp"))
    extra["pp_step_ms"] = round(pp_t * 1e3, 2)
    extra["pp_interleaved_step_ms"] = round(ppi_t * 1e3, 2)
    extra["dp_step_ms"] = round(dp_t * 1e3, 2)
    extra["pp_vs_dp_step_ratio"] = round(dp_t / pp_t, 3)
    extra["pp_interleaved_vs_dp_step_ratio"] = round(dp_t / ppi_t, 3)
    _log(f"  pp(1f1b) {pp_t * 1e3:.1f} ms, pp(interleaved v=2) {ppi_t * 1e3:.1f} ms vs dp {dp_t * 1e3:.1f} ms "
         f"(ratios {dp_t / pp_t:.3f} / {dp_t / ppi_t:.3f}; ideal bubble bounds 0.57 / 0.73 at M=8, S=4)")


def _fed_leg_split(device, extra, launches, peaks, kw):
    sres = _multi_party("_run_split_party", FED_PARTIES, device, launches, (_cluster(FED_PARTIES), kw), peaks=peaks,
                        smoke=False)
    gbps = sum(v["gbps"] for v in sres.values()) / len(sres)
    extra["split_fl_GBps"] = round(gbps, 3)
    extra["split_fl_steps_per_sec"] = round(sum(v["steps_per_sec"] for v in sres.values()) / len(sres), 3)
    extra["split_fl_bf16_steps_per_sec"] = round(sum(v["bf16_steps_per_sec"] for v in sres.values()) / len(sres), 3)
    alice = sres.get("alice", next(iter(sres.values())))
    extra["split_fl_wire_read_ms"] = round(alice["wire_read_ms"], 2)
    extra["split_fl_send_path_ms"] = round(alice["send_path_ms"], 2)
    extra["split_fl_other_ms"] = round(alice["other_ms"], 2)
    extra["split_fl_compute_probe_s"] = round(sum(v["compute_probe_ms"] for v in sres.values()) / 1e3, 4)
    _log(f"  split: {gbps:.3f} GB/s; per-step wire-read {alice['wire_read_ms']:.1f} ms, send-path "
         f"{alice['send_path_ms']:.1f} ms, compute+sched {alice['other_ms']:.1f} ms; bf16 wire "
         f"{extra['split_fl_bf16_steps_per_sec']:.2f} vs f32 {extra['split_fl_steps_per_sec']:.2f} steps/s")


def _fed_leg_push(device, extra, launches, peaks, kw):
    push, reshard, packed, perleaf, overlap, multirail, onerail = _one_child(
        "_run_push_bench", device, launches, timeout=900, args=(kw,), peaks=peaks, smoke=False)
    extra["push_GBps"] = round(push, 3)
    extra["_push_gbps"] = push
    extra["push_reshard_GBps"] = round(reshard, 3)
    extra["multirail_GBps"] = round(multirail, 3)
    extra["singlerail_GBps"] = round(onerail, 3)
    extra["multirail_vs_single_rail"] = round(multirail / onerail, 3) if onerail > 0 else None
    extra["cross_party_packed_GBps"] = round(packed, 3)
    extra["cross_party_perleaf_GBps"] = round(perleaf, 3)
    extra["packed_codec_speedup"] = round(packed / perleaf, 3) if perleaf > 0 else None
    extra["send_overlap_saved_frac"] = round(overlap, 3)
    _log(f"  push: {push:.3f} GB/s wire, {reshard:.3f} GB/s onto the receiver's device; packed tree "
         f"{packed:.3f} GB/s vs per-leaf {perleaf:.3f} GB/s ({extra['packed_codec_speedup']}x), send overlap "
         f"saves {overlap:.0%} of busy time; multirail {multirail:.3f} GB/s vs single-rail {onerail:.3f} GB/s")


def _fed_leg_send_path(device, extra, launches, peaks, kw):
    _fill_send_path_extra(extra, _one_child("_run_send_path_bench", device, launches, timeout=600, args=(kw,),
                                            peaks=peaks, smoke=False))


def _fed_leg_stream_agg(device, extra, launches, peaks, kw):
    _fill_stream_extra(extra, _one_child("_run_stream_agg_bench", device, launches, timeout=600, args=(kw,),
                                         peaks=peaks, smoke=False))


def _fed_leg_ring_agg(device, extra, launches, peaks, kw):
    res = _multi_party("_run_ring_agg_party", RINGB_PARTIES, device, launches, (_cluster(RINGB_PARTIES), kw),
                       timeout=900, peaks=peaks, smoke=False)
    _fill_ring_extra(extra, res)


def _fed_leg_overlap(device, extra, launches, peaks, kw):
    res = _multi_party("_run_overlap_party", OVERLAPB_PARTIES, device, launches, (_cluster(OVERLAPB_PARTIES), kw),
                       timeout=900, peaks=peaks, smoke=False)
    _fill_overlap_extra(extra, res)


def _fed_leg_lora(device, extra, launches, peaks, kw):
    lres = _multi_party("_run_lora_party", FED_PARTIES, device, launches, (_cluster(FED_PARTIES), kw), peaks=peaks,
                        smoke=False)
    lrps = sum(v[0] for v in lres.values()) / len(lres)
    adapter_mb = next(iter(lres.values()))[1]
    extra["lora_2party_rounds_per_sec"] = round(lrps, 3)
    extra["lora_adapter_MB_per_push"] = round(adapter_mb, 3)
    _log(f"  lora: {lrps:.3f} rounds/s, {adapter_mb:.3f} MB adapters/push")


def _fed_leg_resnet(device, extra, launches, peaks, kw):
    barrier = mp.get_context("spawn").Barrier(len(RESNET_PARTIES))
    res = _multi_party("_run_resnet_party", RESNET_PARTIES, device, launches,
                       (_cluster(RESNET_PARTIES), kw, barrier), peaks=peaks, smoke=False)
    _fill_resnet_extra(extra, res)


def _fill_resnet_extra(extra: dict, res: dict) -> None:
    """bench.py's resnet_fedavg keys from the four parties' reports."""
    rps = sum(v[0] for v in res.values()) / len(res)
    xgbps = sum(v[1] for v in res.values()) / len(res)
    extra["resnet_4party_rounds_per_sec"] = round(rps, 3)
    extra["cross_party_goodput_GBps"] = round(xgbps, 3)
    coord = res.get("alice", next(iter(res.values())))
    extra["resnet_coord_wire_read_ms"] = round(coord[2], 2)
    extra["resnet_coord_send_path_ms"] = round(coord[3], 2)
    coord_bytes_per_round = coord[1] * 1e9 * coord[6]
    wire_session_s = (coord[2] + coord[3]) / 1e3
    if wire_session_s > 0:
        extra["cross_party_GBps"] = round(coord_bytes_per_round / wire_session_s / 1e9, 3)
        extra["cross_party_wire_GBps"] = extra["cross_party_GBps"]
    if coord[2] > 0:
        extra["resnet_coord_send_vs_read_ratio"] = round(coord[3] / coord[2], 3)
    step_ms = sum(v[4] for v in res.values()) / len(res)
    cpu_pr = sum(v[5] for v in res.values())
    wall_pr = sum(v[6] for v in res.values()) / len(res)
    extra["resnet_round_step_ms"] = round(step_ms, 1)
    extra["resnet_round_cpu_s_total"] = round(cpu_pr, 2)
    extra["resnet_round_busy_frac"] = round(cpu_pr / wall_pr, 3)
    extra["resnet_round_step_wall_frac"] = round(step_ms / 1e3 / wall_pr, 3)
    decomp_ms = sum(v[9] for v in res.values()) / len(res)
    decomp_perleaf_ms = sum(v[10] for v in res.values()) / len(res)
    extra["resnet_decomp_ms"] = round(decomp_ms, 2)
    extra["resnet_decomp_perleaf_ms"] = round(decomp_perleaf_ms, 2)
    extra["resnet_decomp_speedup"] = round(decomp_perleaf_ms / decomp_ms, 3) if decomp_ms > 0 else None
    extra["resnet_decomp_step_frac"] = round(decomp_ms / 1e3 / wall_pr, 3)
    _log(f"  resnet: {rps:.3f} rounds/s, goodput {xgbps:.3f} GB/s, wire-session {extra.get('cross_party_GBps')} "
         f"GB/s; coordinator wire-read {coord[2]:.1f} ms + send {coord[3]:.1f} ms per round; decomp packed "
         f"{decomp_ms:.1f} ms vs per-leaf {decomp_perleaf_ms:.1f} ms; step {step_ms / 1e3:.2f} s of "
         f"{wall_pr:.2f} s wall, 4-party CPU {cpu_pr:.2f} s")
    floor_rps = sum(v[7] for v in res.values()) / len(res)
    floor_cpu = sum(v[8] for v in res.values())
    extra["resnet_compute_floor_rounds_per_sec"] = round(floor_rps, 3)
    extra["resnet_floor_cpu_s_total"] = round(floor_cpu, 2)
    extra["resnet_fedavg_overhead_ratio"] = round(rps / floor_rps, 3)
    _log(f"  floor (the same local program, in the party processes): {floor_rps:.3f} rounds/s; fedavg/floor "
         f"{rps / floor_rps:.3f}")


def _fed_leg_resnet_dp(device, extra, launches, peaks, kw):
    dp_rps, dp_cpu = _one_child("_run_resnet_dp_control", device, launches, args=(kw,), peaks=peaks, smoke=False)
    extra["resnet_dp_control_rounds_per_sec"] = round(dp_rps, 3)
    extra["resnet_dp_cpu_s"] = round(dp_cpu, 2)
    extra["_resnet_dp_rps"] = dp_rps
    _log(f"  dp control: {dp_rps:.3f} rounds/s ({dp_cpu:.2f} s CPU)")


def _fill_fed_derived(extra: dict) -> None:
    """The keys bench.py computes from two legs' keys, once both are in
    ``extra`` (a failed leg leaves them out): the split step's serialized
    ceiling from the split and push legs, and the ResNet-18 ratios to the DP
    control, with the 4-slice prediction under 0.9."""
    push = extra.get("push_GBps")
    split_compute_s = extra.get("split_fl_compute_probe_s")
    split_sps = extra.get("split_fl_steps_per_sec")
    split_gbps = extra.get("split_fl_GBps")
    if push is not None:
        extra["split_fl_ceiling_steps_per_sec"] = None
        extra["split_fl_vs_ceiling"] = None
    if push and split_compute_s and split_sps and split_gbps:
        step_bytes = split_gbps * 1e9 / split_sps
        wire_s = step_bytes / (extra["_push_gbps"] * 1e9)
        ceiling_sps = 1.0 / (split_compute_s + wire_s)
        extra["split_fl_ceiling_steps_per_sec"] = round(ceiling_sps, 3)
        extra["split_fl_vs_ceiling"] = round(split_sps / ceiling_sps, 3)
        _log(f"  split serialized model: {ceiling_sps:.2f} steps/s (compute {split_compute_s * 1e3:.0f} ms + "
             f"wire {wire_s * 1e3:.0f} ms) -> measured f32 is {extra['split_fl_vs_ceiling']} of it")
    dp_rps = extra.get("_resnet_dp_rps")
    dp_cpu = extra.get("resnet_dp_cpu_s")
    fed_rps = extra.get("resnet_4party_rounds_per_sec")
    fl_rps = extra.get("resnet_compute_floor_rounds_per_sec")
    fl_cpu = extra.get("resnet_floor_cpu_s_total")
    if not (dp_rps and fed_rps and fl_rps and fl_cpu):
        return
    ratio = fed_rps / dp_rps
    extra["resnet_fedavg_vs_dp_ratio"] = round(ratio, 3)
    extra["resnet_batch_efficiency_ratio"] = round(dp_cpu / fl_cpu, 3)
    extra["resnet_vs_dp_method"] = (
        "4-party pipelined FedAvg rounds/s over the real transport divided by the single-process DP "
        "control at the same total batch, both on this host; all parties share the host's cores and "
        "its one card, so process contention and the 4x batch-32-vs-128 gap are inside the measured ratio"
    )
    if ratio < 0.9:
        # The 4-slice model: each party on a card of its own, its round the
        # CPU seconds it used, only the wire not hidden exposed.
        per_slice_s = fl_cpu / 4.0
        wire_s = (extra.get("resnet_coord_wire_read_ms", 0.0) + extra.get("resnet_coord_send_path_ms", 0.0)) / 1e3
        h = float(extra.get("overlap_hidden_comm_frac", 0.0))
        extra["resnet_pred_compute_floor_s"] = round(per_slice_s, 3)
        extra["resnet_pred_wire_s"] = round(wire_s, 3)
        extra["resnet_pred_overlap_frac"] = round(h, 3)
        pred_rps = 1.0 / (per_slice_s + (1.0 - h) * wire_s)
        pred_rps_hidden = 1.0 / max(per_slice_s, wire_s)
        extra["resnet_pred_4slice_ratio"] = round(pred_rps / dp_rps, 3)
        extra["resnet_pred_4slice_ratio_full_overlap"] = round(pred_rps_hidden / dp_rps, 3)
    _log(f"  fedavg/dp ratio {ratio:.3f}")


def _fed_leg_fedavg_mnist(device, extra, launches, peaks, kw):
    res = _multi_party("_run_fedavg_party", FED_PARTIES, device, launches, (_cluster(FED_PARTIES), kw), peaks=peaks,
                       smoke=False)
    extra[HEADLINE] = sum(res.values()) / len(res)


# (section, what it runs, runner), in bench.py's order; _settle() after
# every one but pp_bench and the headline, as there.
FED_LEGS = (
    ("pp_bench", "1F1B + interleaved pipeline vs DP train step (4-rank world)", _fed_leg_pp),
    ("split_fl", "split-FL activation push (two party processes, real transport)", _fed_leg_split),
    ("push_bench", "raw push throughput (128 MB from the sender's device, loopback)", _fed_leg_push),
    ("send_path", "coordinator send-path probe (4-party hub, ResNet-18 bundles, arena + multi-rail)",
     _fed_leg_send_path),
    ("stream_agg", "streaming FedAvg aggregation (ResNet-18 packed rounds, delta cache, 4 parties)",
     _fed_leg_stream_agg),
    ("ring_agg", "ring FedAvg aggregation (ResNet-18 packed rounds, 4-party ring vs hub)", _fed_leg_ring_agg),
    ("overlap", "pipelined FedAvg rounds (4-party overlap vs sync)", _fed_leg_overlap),
    ("lora_2party", "2-party Llama-LoRA federated fine-tune", _fed_leg_lora),
    ("resnet_fedavg", "4-party ResNet-18 FedAvg (real transport) and its contention floor", _fed_leg_resnet),
    ("resnet_dp", "ResNet-18 single-process DP control (north-star denominator)", _fed_leg_resnet_dp),
    ("fedavg_mnist", "2-party FedAvg (real transport)", _fed_leg_fedavg_mnist),
)
FED_LEG_NAMES = tuple(name for name, _, _ in FED_LEGS)
# The keys each leg sets (bench.py's), the 4-slice prediction's (under a
# fedavg/dp ratio of 0.9) and the environment's.
FED_KEYS = {
    "pp_bench": ("pp_step_ms", "pp_interleaved_step_ms", "dp_step_ms", "pp_vs_dp_step_ratio",
                 "pp_interleaved_vs_dp_step_ratio"),
    "split_fl": ("split_fl_GBps", "split_fl_steps_per_sec", "split_fl_bf16_steps_per_sec", "split_fl_wire_read_ms",
                 "split_fl_send_path_ms", "split_fl_other_ms", "split_fl_compute_probe_s"),
    "push_bench": ("push_GBps", "push_reshard_GBps", "multirail_GBps", "singlerail_GBps", "multirail_vs_single_rail",
                   "cross_party_packed_GBps", "cross_party_perleaf_GBps", "packed_codec_speedup",
                   "send_overlap_saved_frac", "split_fl_ceiling_steps_per_sec", "split_fl_vs_ceiling"),
    "send_path": ("cross_party_wire_GBps", "send_path_wire_GBps", "push_capability_GBps", "wire_vs_push_capability",
                  "send_vs_read_wall_ratio", "coord_wire_read_ms", "coord_send_path_ms", "send_path_overhead_ratio",
                  "send_path_breakdown_ms", "send_path_striped_payloads", "local_link_GBps", "local_link_backend",
                  "local_link_uds_GBps", "local_link_vs_wire"),
    "stream_agg": ("cross_party_stream_agg_GBps", "agg_overlap_frac", "delta_bytes_saved_frac", "stream_agg_round_ms",
                   "stream_agg_contrib_ms", "stream_agg_bcast_ms", "stream_agg_busy_ms", "stream_agg_tail_ms",
                   "stream_agg_wire_ms", "stream_agg_bundle_mb"),
    "ring_agg": ("ring_agg_GBps", "ring_vs_coord_speedup", "coord_bytes_in_frac", "coord_bytes_in_frac_hub",
                 "ring_coord_ingress_vs_hub", "ring_round_ms", "hub_round_ms", "ring_bundle_mb", "ring_quant_bytes_frac",
                 "ring_quant_round_ms", "ring_f32cold_round_ms"),
    "overlap": ("overlap_hidden_comm_frac", "round_wall_speedup", "overlap_round_ms", "sync_round_ms",
                "overlap_comms_ms_per_round", "overlap_local_ms_per_round"),
    "lora_2party": ("lora_2party_rounds_per_sec", "lora_adapter_MB_per_push"),
    "resnet_fedavg": ("resnet_4party_rounds_per_sec", "cross_party_goodput_GBps", "resnet_coord_wire_read_ms",
                      "resnet_coord_send_path_ms", "cross_party_GBps", "cross_party_wire_GBps",
                      "resnet_coord_send_vs_read_ratio", "resnet_round_step_ms", "resnet_round_cpu_s_total",
                      "resnet_round_busy_frac", "resnet_round_step_wall_frac", "resnet_decomp_ms",
                      "resnet_decomp_perleaf_ms", "resnet_decomp_speedup", "resnet_decomp_step_frac",
                      "resnet_compute_floor_rounds_per_sec", "resnet_floor_cpu_s_total", "resnet_fedavg_overhead_ratio"),
    "resnet_dp": ("resnet_dp_control_rounds_per_sec", "resnet_dp_cpu_s", "resnet_fedavg_vs_dp_ratio",
                  "resnet_batch_efficiency_ratio", "resnet_vs_dp_method"),
    "fedavg_mnist": ("metric", "value", "unit", "vs_baseline"),
}
FED_PRED_KEYS = ("resnet_pred_compute_floor_s", "resnet_pred_wire_s", "resnet_pred_overlap_frac",
                 "resnet_pred_4slice_ratio", "resnet_pred_4slice_ratio_full_overlap")
ENV_KEYS = ("env_cpu_count", "env_loadavg_1m", "env_platform", "env_device_kind")
_NO_SETTLE = ("pp_bench", "fedavg_mnist")


def run_fed(device: str = "cuda", stats: Optional[dict] = None, legs=FED_LEG_NAMES,
            leg_kw: Optional[dict] = None, settle_s: float = SETTLE_S, lanes: int = 1) -> dict:
    """bench.py's federated section on ``device``: every leg of ``legs`` in
    its order, each in its spawned processes with every party's compute on
    ``device``, ``settle_s`` of sleep after each leg (bench.py's
    ``_settle()``).  Returns the record ``bench.py --fed-only`` prints: the
    headline ``fedavg_mnist_2party_rounds_per_sec`` (``vs_baseline`` 1.0:
    the reference's ``BENCH_r*.json`` hold the JAX package's CPU numbers),
    every leg's keys, a failed leg's ``{leg}_error``.  ``leg_kw[leg]`` are
    keyword arguments of that leg (sizes and counts; the reference's by
    default).  ``stats``, when given, gets ``stats[leg]``: the leg's wall
    ``s`` (its processes' start included), its children's kernel
    ``launches`` and their largest ``peak_bytes`` on the card (None on the
    CPU).  ``lanes`` > 1 runs that many legs at once, each lane taking the
    next leg when its last has ended and settled, as ``run_smoke``'s: the
    legs share no port or process, only the host's cores and the card.
    Raises before any leg when the card is asked for and there is none."""
    _check_device(device)

    def one(entry) -> dict:
        name, msg, runner = entry
        extra: dict = {}
        launches: collections.Counter = collections.Counter()
        peaks: list = []
        t0 = time.perf_counter()
        with _section(extra, name):
            _log(f"{msg} on {device}...")
            runner(device, extra, launches, peaks, (leg_kw or {}).get(name))
        wall = time.perf_counter() - t0
        leg_stats = {"s": wall, "launches": dict(launches), "peak_bytes": max(peaks) if peaks else None}
        _log(f"  {name}: {wall:.1f} s, " + json.dumps({k: v for k, v in leg_stats.items() if k != "s"}))
        if stats is not None:
            stats[name] = leg_stats
        if name not in _NO_SETTLE:
            time.sleep(settle_s)
        return extra

    chosen = [entry for entry in FED_LEGS if entry[0] in legs]
    extra = _env_keys(device)
    if lanes == 1:
        by_leg = [one(entry) for entry in chosen]
    else:
        with concurrent.futures.ThreadPoolExecutor(lanes) as pool:
            by_leg = list(pool.map(one, chosen))
    for leg_extra in by_leg:
        extra.update(leg_extra)
    _fill_fed_derived(extra)
    for key in ("_push_gbps", "_resnet_dp_rps"):
        extra.pop(key, None)
    rps = extra.pop(HEADLINE, None)
    if rps is not None:
        record = {"metric": HEADLINE, "value": round(rps, 3), "unit": "rounds/s", "vs_baseline": 1.0}
    else:  # the headline leg failed (its error is in extra): the reference's fallback
        record = {"metric": "llama_tokens_per_sec", "value": extra.get("llama_tokens_per_sec", 0.0),
                  "unit": "tokens/s", "vs_baseline": 1.0}
    record.update(extra)
    return {k: (None if isinstance(v, float) and v != v else v) for k, v in record.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true", help="run the twelve smoke legs and their gates")
    ap.add_argument("--compute-only", action="store_true", help="run the compute section's five legs")
    ap.add_argument("--fed-only", action="store_true",
                    help="run the federated section's legs only (with no mode flag: the federated section, then "
                         "the compute section)")
    ap.add_argument("--device", default="cuda", help="the legs' device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.fed_only and args.compute_only:
        raise SystemExit("--fed-only and --compute-only are mutually exclusive")
    if args.smoke:
        return _smoke_main(args.device)
    if args.compute_only:
        record = run_compute(args.device)
    else:
        record = run_fed(args.device)
        if not args.fed_only:
            compute = run_compute(args.device)
            if record["metric"] != HEADLINE:  # the headline leg failed: the llama headline, as bench.py
                record.update({k: compute[k] for k in ("metric", "value", "unit", "vs_baseline")})
            record.update({k: v for k, v in compute.items() if k not in ("metric", "value", "unit", "vs_baseline")})
    print(json.dumps(record), flush=True)
    errors = [k for k in record if k.endswith("_error")]
    for name in errors:
        _log(f"leg FAILED: {name}: {record[name]}")
    return 1 if errors else 0


def _smoke_main(device: str) -> int:
    record, failed = run_smoke(device)
    print(json.dumps(record), flush=True)
    for gate in GATES:
        verdict = gate_passes(gate, record)
        if verdict is None:
            _log(f"gate {gate.name}: skipped ({gate.requires} absent: "
                 f"{record.get('hier_n256_skipped', 'leg not run')})")
        elif not verdict:
            want = "true" if gate.op == "true" else f"{gate.op} {gate.threshold!r}"
            _log(f"smoke gate FAILED: {gate.name}={record.get(gate.key)!r} (must be {want}; {gate.kind})")
    for name in failed:
        if name.endswith("_error"):
            _log(f"smoke leg FAILED: {name}: {record[name]}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
