"""Smoke run of the PyTorch/CUDA port (rayfed_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build the CUDA kernels from the sources in the checkout (one nvcc per
     source, in parallel: the flash forward, the flash backward and the
     float fold's fused multiply-add); print each kernel function's registers and
     spills (-Xptxas -v) and its HGMMA (wgmma) and UTMALDG (TMA load)
     instructions (cuobjdump -sass), and fail unless each tensor-core
     kernel (the forward, dQ and dK/dV) has all 4 instantiations and each
     holds both;
  2. hold each kernel against its plain PyTorch version on the card, at the
     main paths' shapes and at the edge cases (window, offsets with fully
     masked rows, ragged T, head dim 64, f32 in/out, f32 gradients from
     bf16 inputs, and bert_base's attention: [384, 512, 64] bf16,
     non-causal), with exact zeros where no key or no query is visible;
     bf16 inputs run all three kernels on the tensor cores, which sum in
     their own order, so no bf16 case is bit-identical to the plain
     version, not even at head dim 64;
  3. drive the serving path: Llama-3-8B at full width and depth (random
     bf16 weights from a seed) serving 4 prompts of 2048 tokens, 32 greedy
     new tokens each, with flash-attention prefill; check the kernel ran
     once per layer, the outputs are sane, and batch-1 prefill logits agree
     with the dense-attention path;
  4. drive the training path: 4 LoRA (rank 16 on wq/wv) Adam steps of
     Llama-3-8B at full width and depth, bf16 base, remat, B=1, T=2048,
     through the flash forward and both backward kernels; check the launch
     counts per step, finite and falling losses and unchanged adapter
     scales; then, at depth 4, hold every adapter gradient through flash
     attention against the one through dense attention;
  5. drive the federated path: two party processes, alice and bob, on the
     one card, running one driver through ``rayfed_tpu_torch``'s API.
     alice's ``@fed.remote`` actor holds the Llama-3-8B base (bf16, full
     width and depth, random from the seed) with rank-16 adapters on
     w[qv], takes one LoRA step through the three kernels (64/32/32
     launches, counted in her process) and returns the adapters (27.3 MB
     f32); a second method returns the stacked wq (1.07 GB bf16).  Both
     parties fetch both; bob's arrive on his card, and a task of each
     party fingerprints (SHA-256, dtypes, shapes, device) what it holds,
     which must agree.  Once over TCP, once with the local link "auto";
     prints each transfer's time and GB/s, the decided backend, the
     step's time and bob's D2H and H2D copies of wq;
     In the same processes, after both exchanges, a packed FedAvg round
     (local link "auto"): each party's ``@fed.remote`` trainer holds the
     same Llama-3-8B base (from the seed) and takes one LoRA step per
     round on its own token ids, and both run ``fl.run_fedavg_rounds``
     for 2 rounds with bf16 packed wire and ``streaming_agg`` — bob pushes
     his 13.63 MB packed adapters on a delta stream, alice folds them on
     her card with her own and broadcasts the mean.  Checks: 64/32/32
     launches in every step of both parties, equal SHA-256 fingerprints of
     both parties' final adapters (all leaves on the card), delta frames in
     round 2; prints each round's local/push/agg seconds, alice's
     aggregator stats and each party's peak memory.  Then, in the same
     processes and from that result, 2 compressed-domain rounds
     (``wire_quant="uint8"``: the first ships bf16, having no grid yet, the
     second uint8 codes on a grid ranged by the first's delta, folded in
     i32 on alice's card and broadcast re-quantized): the same checks,
     and bob's second push under 0.6x his bf16 push.  Then 2 ring rounds
     (``mode="ring"``: two stripes, each folded by its owner on its card,
     gathered back): 64/32/32 launches per step, the fold kernel at both
     parties, equal fingerprints.  Then the pipelined rounds
     (``overlap=True``: round k's exchange and fold on a comms lane under
     round k+1's steps, one round of staleness fixed by the DGA correction):
     3 in coordinator mode, 2 ring, 2 ``wire_quant="uint8"``; 64/32/32
     launches per step, equal fingerprints, the fold kernel where floats
     fold, every ring round a ring, and the coordinator-mode result equal
     byte for byte to the DGA recurrence replayed on the card from each
     party's recorded step outputs; prints each part's walls beside the
     synchronous rounds';
  6. the fold alone, before the party processes start: first every form
     of the fold kernel against its plain version on the card, byte for
     byte (the step and the pair at lengths 1, 7, 8 and 2^21+3 with the
     operands at element offsets 0-7; the chain of 1, 2, 3, 4 and 9
     operands, bf16 and f32 wire and output, three weight sets; the rows
     form at the codec's block shapes); then 2 contributions at
     the adapters' size and 4 at the stacked wq's (536.9e6 bf16 elements),
     from the seed, fed through a CUDA ``StreamingAggregator``'s sinks in
     512 KiB pieces in a shuffled interleaving (one added as the local
     contribution); its result, and the one-shot fold on the card, must
     equal the CPU fold byte for byte, weights 3/5/7/11 and None, the
     one-shot fold in exactly one launch (the chain) and each streamed
     contribution in one launch a run of blocks; prints the fold's device
     ms per contribution as one run and block by block, a block launch's
     host and device µs, the one-shot fold against 2n+2 B/element, the H2D
     ms of a contribution, the finalize and error-feedback ms, and the
     fold's GB/s against HBM, beside addcmul_; the fold kernel is counted
     on the round path (alice's folds, by form).
     The same for the compressed-domain fold (uint8 codes on one grid,
     folded in i32, streamed and one-shot): the i32 accumulator and the
     finalized f32 must equal the CPU's byte for byte; prints the i32 fold,
     finalize, quantize and dequantize device ms beside their bounds.  This
     part and the round session (5) run with the plain ``ops.fold.fma_ftz``
     raising on a CUDA tensor: the codec's FMAs take the kernel's rows form;
  8. (after 4) the int8 serving path: Llama-3-8B on an int8 base
     (``init_llama_int8``), the int8 KV cache and a 1024-token sliding
     window, 4 prompts of 2048 tokens through the flash prefill (32
     launches), then 32 greedy steps of the linear int8 decode and of the
     rolling decode on a 1024-slot ring, on the same tokens: the logits
     within 5% of their range and the same greedy token in 90% of steps;
     the int8 cache at most 0.53x the bf16 cache's bytes; batch-1 prefill
     logits through flash vs dense; prints prefill and decode times, cache
     bytes and peak memory beside the bf16 path's;
  9. (after 8) the training path over the int8 base, BASELINE config #4 as
     ``bench_lora_8b`` runs it: 4 LoRA steps as in 4, the same checks, and
     peak memory at least 5 GB below the bf16 base's step;
  10. (after 5) the split path, BASELINE config #5: two party processes on
     the one card, one driver through ``fl.SplitTrainer``; alice holds
     bert_base's embeddings, 12 layers and pooler (bf16 activations, f32
     params, random from the seed) and the token ids [32, 512], bob the
     head and the labels (the parity of the first token id); the encoder's
     attention is flash_attention.  6 serialized steps, 3 pipelined over 4
     microbatches of 8, 3 with a bf16 wire.  Checks: 24/12/12 launches per
     serialized step in alice (the forward, the backward's recompute, the
     backward), 0 in bob, finite and falling losses per mode, equal
     fingerprints of both trainers' final params on both parties; prints
     each mode's step ms and steps/s, the activation and gradient bytes per
     step with their push ms and GB/s, and each party's peak memory.  Then,
     in this process, the encoder's gradients at depth 2 through flash vs
     dense attention (5% of max|g|), and the HF conversion of a 2-layer
     Llama-3-8B-width state dict on the card, which must give the params
     back exactly;
  11. (after 10) the topologies, BASELINE config #3: four party processes
     (alice, bob, carol, dave) train ResNet-18 (10 classes, random from the
     seed) one SGD step per round on synthetic CIFAR-10-shaped shards of 32
     images and average with bf16 packed wire: 3 hub rounds
     (``streaming_agg``), 3 ring rounds from the same start, 2 quantized
     ring rounds (``wire_quant="uint8"``), then 3 quorum rounds
     (``quorum=2``, a 3 s deadline) under a seeded chaos schedule: carol
     straggles 8 s in round 1, dave crashes at round 1 and the coordinator
     alice after round 2's cutoff.  Checks: equal fingerprints within each
     part, the ring's final params equal the hub's, alice's share of the
     cluster's ingress in the ring at most 0.4, the quantized ring round's
     bytes under 0.6x a bf16 ring round's, the fold kernel at every ring
     party and quorum coordinator; in the quorum part alice and dave exit
     with the crash code, bob and carol finish every round with equal
     params, round 1 aggregates a strict subset, the roster epoch reaches 2
     and each survivor failed over once; prints each round's wall,
     local/push/agg seconds, sent and received bytes and fold launches.
     phase_hierarchy, in the same processes before the quorum part, each
     from the same start: 4 rounds of ``mode="hierarchy"`` (uint8, two
     regions of two, weights 32; round 0 is the flat bootstrap), 4 of the
     flat quantized hub, 3 of the quorum loop over the tree.  Checks: equal
     fingerprints at every party and the tree's equal to the hub's, every
     tree round completed as a tree (no abort, no fallback), int16 partial
     sums, no flash launch, and a party's mean bytes sent and received per
     tree round (from round 2) at most 1.25 x 2·|model| (bf16);
  12. (after 11) phase_hierarchy_multilevel, in this process: 16 virtual
     parties (bare TransportManagers on loopback), region_size 4 and
     branch 2 (4 leaf regions, 2 interior nodes, the root), each
     contribution a ResNet-18-sized f32 buffer on the card from the seed,
     weight 32, uint8 on one grid.  Round 1 must equal
     ``packed_quantized_sum`` over the 16 on the card and on the CPU byte
     for byte at every party, with int16 leaf sums and int32 interior sums;
     round 2 (``region_quorum=3``) holds one member past its region's 3 s
     deadline and must equal the sum over the 15 that arrived, with a
     region cutoff and no aborted round.  Prints the walls, the root's
     egress, the largest ingress, the integer fold's calls per level and,
     alone on the card, its ms per block against its byte bound;
  13. (after 6) phase_server_opt, in this process: the packed server
     optimizers' step and resync (``fl/fedavg.py`` ``server_step_kernel``
     and ``server_resync_kernel``, their fused multiply-adds on the fold
     kernel) at 4099 elements, a ResNet-18 buffer and the Llama-3-8B w[qv]
     adapters, under server momentum, FedAC and both plain-FedAvg configs,
     byte-equal to the CPU plain version; their device ms, fold launches
     and byte bounds; FedAC's rounds to target on the two-party quadratic
     through the card's step and resync, at most 0.8x plain FedAvg's; the
     post-step quantized downlink, decoded from its wire bytes, byte-equal
     across the streaming fold, a quorum cutoff round and the hierarchy's
     regrouped fold, on the card and the CPU.  In the round session (5),
     after the pipelined parts: 2 rounds of ``wire_quant="uint8"`` under
     ``server_opt=fedac(1.0, 3.0, 0.5)`` and 2 pipelined rounds under
     ``server_momentum(1.0, 0.9)``; 64/32/32 launches per step, equal
     adapters, and the optimizer state's SHA-256 equal at both parties after
     every resync, on the card; prints the walls beside the same run's
     rounds without the optimizer.  In the topology processes (11), after
     the hierarchy's parts: 3 tree rounds and 3 flat quantized hub rounds
     under FedAC from the same start, equal params at all four parties and
     between the two, no aborted or fallback round, no flash launch;
  14. (after 12) phase_async, in this process: ``run_async_fleet`` with
     virtual parties (a thread each over bare TransportManagers, the
     buffer and the models on the card).  The quadratic under a 2-10x
     straggler against the thread-barrier loop (``async_tt_frac`` at most
     0.8), every emitted version byte-equal to the sorted refold of its
     recorded folds on the card and the CPU; 64 parties' version rate (at
     least 1 a second); BASELINE #3 asynchronous (3 ResNet-18 members, one
     4x slower, 4 cycles, buffer 2): every version refolded, stale folds,
     no flash launch, the fold's device ms; then 2 cycles under server
     momentum, the emitted models equal to the step replayed on the card;
  15. (after 14) phase_secagg: secure aggregation, DP clipping and the
     robust reducers.  Prints the negotiated suite (x25519/aes with the
     ``cryptography`` package, else nonce/philox, whose group key this
     script sets in its environment for every party process).  (a) The
     weight-and-mask step and the dropout correction on the card against
     the CPU at the ring's wrap edges and at 11.18e6 elements, 0 differing
     elements, their device ms beside their byte bounds.  (b) In the
     topology processes (11), after the hierarchy's parts: 3 quorum rounds
     of BASELINE #3 (uint8, ``quorum=3``, ``secure_agg=True``) in which dave
     crashes at round 1, so the cutoff recovers his masks, then the same
     schedule unmasked: equal SHA-256 at every survivor, at least one mask
     recovery at alice; prints both runs' round walls and their ratio.
     (c) In the round session (5), last: 3 compressed-domain rounds plain,
     3 masked (the flash kernels in every step), then the masked run's
     recorded train outputs replayed through plain rounds: the masked final
     equals the replay's at both parties; prints the walls, the masking
     overhead and alice's unhidden keystream time.  (d) tree_median,
     tree_trimmed_mean(trim=1), krum(num_byzantine=1) and
     clip_by_global_norm over four ResNet-18 contributions (one x100) on
     the card: the reducers equal the CPU's by SHA-256, the clip within
     1e-5 relative; their device ms beside their byte bounds;
  16. (after 15) phase_checkpoint: per-party snapshots (``FedCheckpointer``)
     and resume.  (a) In the round session (5), last: two uninterrupted
     runs of 4 Llama-3-8B LoRA rounds under FedAC (``streaming_agg``, one
     step per round from the broadcast with a fresh Adam state, a snapshot
     every round), which must agree at every snapshot; then two fresh party
     processes whose checkpointers hold the first run's snapshots to round
     2 resume it: the restored state equals the saved one byte for byte,
     the steps launch 64/32/32, and the final adapters and FedAC state
     equal the uninterrupted run's by SHA-256 at both parties.  (b) Four
     ResNet-18 party processes (BASELINE #3, ``quorum=2``) run 4 rounds
     with a snapshot every round, then the same run crashes at round 2 at
     every party (the chaos harness), and four fresh processes resume it
     from the snapshots with the flight recorder armed: the final params
     equal the uninterrupted run's at every party, the member log spans the
     restart, and alice's ``fed.trace_collect`` carries spans from all four
     parties and the ``ckpt.save``/``ckpt.restore`` spans, exports to
     Perfetto, and ``tool/trace_report.round_report`` agrees with every
     round's driver span within 0.25.  Prints the save ms and bytes, the
     restore ms from the content cache and from disk, the snapshot's size;
  17. (after 16) phase_parallel: party-local parallelism, worlds of rank
     processes on the one card (gloo; the ring's K/V rotations and the
     gathers staged through pinned host buffers).  Four ranks: (1) the
     flash ring (causal and not), the zigzag ring and Ulysses with
     flash_attention inside, forward and backward on [1, 16384, 32, 128]
     bf16 (4096 tokens a rank), each held against one-card flash_attention
     on the same global tensors (3e-2), with each rank's forward, dQ and
     dK/dV launches held to ``par_launches``; one ring step's kernel
     against one rotation and the bytes it stages; (3) TP/FSDP:
     ``ShardingStrategy(param_rules=llama.PARTITION_RULES)`` on
     {fsdp: 2, tp: 2} at llama3_8b() width and 2 layers, logits against
     the unsharded forward (5% of max|logit|); (4) one MoE layer at Switch
     base-128's widths, B=8 T=512, ep=4, against the one-rank layer (1e-5).
     Then two ranks, sp=2: (2) Llama-3-8B at full width and 8 of its 32
     layers (``sp_layers``), a bf16 replica a rank, prefill of 8192 tokens
     and one LoRA step (rank 16 on w[qv], remat, T=4096) through the zigzag
     ring, against one-card flash (logits 5% of max|logit|, loss and adapter
     gradients 5% of max|g|); prints each part's ms, each rank's peak memory
     and the backend;
  18. (after 17) phase_pipeline: pipeline parallelism, one world of 4 rank
     processes on the card (gloo; every hop and the replicating broadcasts
     staged through pinned host buffers), Llama-3-8B at full width (random
     bf16 weights from the seed), the stage a run of its decoder layers with
     flash_attention, the embedding and the head outside the pipe, B=8
     sequences of 2048 tokens in M=8 microbatches.  (a) GPipe's forward at
     pp=4 and full depth (8 layers a stage): the logits (the head applied a
     sequence at a time) within 5% of max|logit| of one-card apply_llama;
     (b) one 1F1B step at 8 layers (2 a stage), lm_loss through the fixed
     head: the loss within 1e-3 relative and every stacked gradient within
     5% of max|g| of one-card autograd; (c) one interleaved step, pp=2 v=2
     on the world's first two ranks, against (b)'s loss and gradients; each
     rank's forward, dQ and dK/dV launches held to ``pp_launches``; prints
     each part's ms (slowest rank), the bubble, the MB of a hop and staged,
     and each rank's peak memory;
  19. (after 18) phase_party_processes: a party of two processes.  Five
     processes on the card: alice's two, bob, carol and dave.  First alice
     as one process: one BASELINE #3 round (resnet18, coordinator bob) whose
     alice step is the mean gradient of two halves of her 32 images.  Then
     alice as two processes (``coordinator_address``, ``num_party_processes=2``,
     ``mesh_shape={"dp": 2}``, one gloo world on the card): (a) bob's 64 MB
     f32 tensor reaches both (the leader over the wire, the member through
     the leader's bridge), SHA-256 equal to bob's, and an all-reduce over her
     mesh gives its sum; (c) the collective ``set_max_message_length`` on
     both processes and back; (b) the same round with her step data-parallel
     over her two ranks (16 images each, gradients all-reduced): its final
     model within 5% of max|Δ| of the one-process round, equal SHA-256 at all
     five processes; (d) her leader killed while her member waits on a value
     of bob's: the member's recv raises a RemoteError naming the leader
     within the watchdog's deadline (interval × (pings + 1) + 2 s), not the
     60 s backstop.  Prints the bridge's bytes and ms, the cap's ms, the
     round's walls and the time to the poison;
  20. (after 19) phase_examples: the seven files of ``examples_torch/`` at
     their own sizes, rounds and seeds, with ``device`` left at its default:
     each federated example's ``run`` in its own party processes on free
     ports (mesh_fedavg's two parties two processes each, sharing the card
     over gloo), serve_llama in this process.  Checks: every process exits
     0 on ``cuda``, the examples' own assertions, equal results at every
     party, no flash launch (dense attention, as the JAX examples) and no
     fold_fma launch (no example packs its contribution); prints each
     example's wall, its processes' run times, results and fold launches;
  21. (after 20) phase_bench_smoke: ``bench_torch.py --smoke``'s twelve
     legs in their spawned children with the parties on the card, two legs
     at a time (``BENCH_SMOKE_LANES``); fatal on
     a leg's error, a missed exact gate, a flash launch, or no fold_fma
     launch in a leg that folds floats; the timed gates are printed;
  22. (after 21) phase_bench_compute: ``bench_torch.py --compute-only``'s
     five legs in this process at the reference's widths, batches and
     shapes (repetition counts in ``BENCH_COMPUTE_KW``): the ~1.07B Llama's
     Adam step (B=2, T=2048, remat "dots") with its MFU breakdown, its
     KV-cache decode (bf16, int8 weights, 1536-token context with the int8
     cache), flash vs dense attention chains, Llama-3-8B's int8-base LoRA
     step and int8 decode, MoE scatter vs einsum dispatch.  Checks: no leg
     error, every value finite and positive (the breakdown's residual,
     which the reference clamps at 0, finite and at least 0), ``llama_mfu`` and every
     ``*_membw_util`` at most 1.05, the flash launches of every leg that
     reaches attention and 2L/L/L a train step; prints each leg's wall,
     launches, peak memory and every key;
  23. (beside 21, before 22) phase_bench_fed: ``bench_torch.py --fed-only``'s eleven
     legs in their spawned children and ranks with every party's compute
     on the card, at the reference's widths, tensors and bundles
     (repetition counts in ``BENCH_FED_KW``, ``BENCH_FED_SETTLE_S`` after
     each leg, two legs at a time, ``BENCH_FED_LANES``): the pipelines
     against DP over 4 gloo ranks, split learning's
     activation push, the 128 MB push from the card, the full-size
     send-path, streaming, ring and overlap legs, the 2-party Llama-LoRA
     fine-tune, 4-party ResNet-18 FedAvg and its DP control, the headline
     2-party FedAvg.  Checks: no leg error, every key of the reference's
     section present and finite, timed keys > 0, the size-fixed keys the
     port's own sizes, no flash launch, a fold_fma launch in every leg that
     folds floats, no JAX in any child; prints each leg's wall, launches
     and peak memory;
  7. time each kernel (mean over one window of calls) against its plain
     version, the library call that computes the same function, and the
     card's bound (the forward at the serving shape B=4 and at the training
     shape B=1, the three at bert_base's shape), and the host's time to
     enqueue one forward and one dQ.
Prints each phase's wall, the card (nvidia-smi), a JSON line of kernel
numbers and, last, the result line.  Exits non-zero without a result when there is no CUDA card.
Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import multiprocessing as mp
import os
import queue
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

from rayfed_tpu_torch import fl
from rayfed_tpu_torch.checkpoint import FedCheckpointer
from rayfed_tpu_torch.fl import fedavg, streaming
from rayfed_tpu_torch.models import bert, hf, llama, lora
from rayfed_tpu_torch.models.logistic import softmax_cross_entropy, value_and_grad
from rayfed_tpu_torch.ops import _build, fold, ftz
from rayfed_tpu_torch.ops import rms_norm as rms_norm_op
from rayfed_tpu_torch.ops.attention import dot_product_attention
from rayfed_tpu_torch.utils.ports import free_loopback_ports as _free_ports
from rayfed_tpu_torch.ops.flash_attention import (
    NEG_INF,
    _flash_backward,
    _flash_backward_reference,
    _flash_bwd_dkv,
    _flash_bwd_dkv_reference,
    _flash_bwd_dq,
    _flash_bwd_dq_reference,
    _flash_forward,
    _flash_forward_reference,
    _lse_delta,
    flash_attention,
)

SEED = 0
BATCH, PROMPT_LEN, NEW_TOKENS = 4, 2048, 32
# Dense peaks of the H100 (NVIDIA data sheet): bf16 tensor-core FLOP/s, HBM bytes/s.
PEAKS = {"PCIe": (756e12, 2.0e12), "NVL": (835e12, 3.9e12), "SXM": (989e12, 3.35e12)}
# Tolerances of the kernel vs its plain version.  f32 inputs: summation
# order only.  bf16 outputs: the two round p and o to bf16 at different
# running maxima, so o may differ by up to two bf16 ulps; lse is f32 from
# exact bf16 products.
TOL = {
    torch.float32: dict(o_atol=1e-4, o_rtol=1e-4, lse_atol=1e-4),
    torch.bfloat16: dict(o_atol=1e-2, o_rtol=2.0**-6, lse_atol=1e-3),
    # bf16 in, f32 out (the ring's partials): o is not rounded at the end,
    # only p is (at the running max vs the row's max).  On the full ring
    # blocks, where a typical |o| is ~2e-2, o differed by at most 4.2e-4 on
    # an H100 (PERF.md), so 2e-3 keeps a 5x margin.
    (torch.bfloat16, torch.float32): dict(o_atol=2e-3, o_rtol=2.0**-6, lse_atol=1e-3),
}
# Batch-1 prefill logits through the kernel vs through dense attention,
# after 32 bf16 layers: the two paths round attention differently, so the
# gap is held to 5% of the logits' range (a wrong mask moves them by ~100%).
LOGIT_REL_TOL = 0.05
# Backward kernels vs their plain versions: |g - ref| <= frac * max|ref| +
# rtol * |ref|.  f32: summation order only.  bf16: both round dS and P to
# bf16 before the second products, and the tensor cores' f32 scores and
# sums differ from the plain version's in the last bits (at every head dim,
# dQ included), so a few dS values round the other way; the gradients are
# then rounded to bf16 (2^-6 relative) and sums over up to 2048 keys add the
# flipped roundings (1e-2 of the largest gradient).
BWD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 2.0**-6)}
# The kernels at the shapes and dtypes a ring step of phase_parallel (1)
# launches them: bf16 q/k/v [B·H = 32, T_local, 128] with f32 partials out.
# The flash ring's blocks (4096 tokens a rank: the causal ring's diagonal
# step 0, a later full step) and the zigzag ring's halves (2048: step 0's
# diagonal halves, a later step's full half blocks).  The backward case of
# the causal half is bf16_in_f32_out.
RING_STEP_CASES = [
    # name, bh, t_q, t_k, d, dtype, out_dtype, causal, q_offset, kv_offset, window
    ("ring_step_diag", 32, 4096, 4096, 128, torch.bfloat16, torch.float32, True, 0, 0, None),
    ("ring_step_full", 32, 4096, 4096, 128, torch.bfloat16, torch.float32, False, 0, 0, None),
    ("zigzag_half_causal", 32, 2048, 2048, 128, torch.bfloat16, torch.float32, True, 0, 0, None),
    ("zigzag_half_full", 32, 2048, 2048, 128, torch.bfloat16, torch.float32, False, 0, 0, None),
]
# The training slice: BASELINE config #4's LoRA fine-tune step.
TRAIN_STEPS, TRAIN_LEN, LORA_RANK, TRAIN_LR = 4, 2048, 16, 1e-3
# Every adapter gradient through the kernels vs through dense attention, at
# depth 4 in bf16: the two paths round attention and its gradients
# differently, so the gap is held to 5% of the dense gradient's max |g| (a
# wrong mask or a missing term moves it by ~100%).
GRAD_REL_TOL, GRAD_CHECK_LAYERS = 0.05, 4
# The split path: BASELINE config #5, bert_base() (head dim 64, non-causal)
# with bf16 activations over f32 params, the encoder and pooler at alice,
# the head at bob; 32 sequences of 512 tokens, 4 microbatches of 8 in the
# pipelined step.  SGD at 0.004: at 0.01 the loss on the one batch
# oscillated from the fifth step on.
SPLIT_BATCH, SPLIT_LEN, SPLIT_MICRO, SPLIT_LR = 32, 512, 4, 0.004
SPLIT_MODES = (("serial", 6), ("pipelined", 3), ("bf16_wire", 3))
SPLIT_GRAD_LAYERS = 2
BERT_BH = SPLIT_BATCH * 12  # B·H of bert_base's attention
BERT_ERRS = {}  # each kernel's max abs error vs its plain version at the BERT shape


def _sync_ms(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _host_us(fn, calls=20):
    """The host's side of one call (checks, tensor maps, launch) in µs: the
    time to enqueue a run of calls, before the card finishes them."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def _peaks(name):
    for key, peaks in PEAKS.items():
        if key in name:
            return key, peaks
    return "SXM", PEAKS["SXM"]


FLASH_KEYS = ("fwd", "bwd_dq", "bwd_dkv")
# The RMSNorm kernels' launches (ops/rms_norm.py): forward, backward, and the
# reduce of dscale's partials (where a norm's scale trains).
NORM_KEYS = ("norm_fwd", "norm_bwd", "norm_dscale")
COUNT_KEYS = FLASH_KEYS + NORM_KEYS


def _counts():
    """This process's launches of the three flash kernels and of the RMSNorm
    kernels (``norm_*``) since ``_zero_counts``."""
    out = {name: getattr(flash_attention, f"{name}_launches") for name in FLASH_KEYS}
    out.update({key: getattr(rms_norm_op.rms_norm, f"{key[5:]}_launches") for key in NORM_KEYS})
    return out


def _zero_counts():
    for name in FLASH_KEYS:
        setattr(flash_attention, f"{name}_launches", 0)
    rms_norm_op.reset_launches()


def _flash(counts):
    """The flash kernels' part of a ``_counts()`` record."""
    return {k: counts[k] for k in FLASH_KEYS}


def _bench_norms(launches):
    """The RMSNorm kernels' launches over every leg of a ``bench_torch``
    run's ``{leg: {kernel: n}}``, keyed as ``_counts()`` keys them."""
    return {f"norm_{k}": sum(n.get(f"rms_norm_{k}", 0) for n in launches.values()) for k in ("fwd", "bwd", "dscale")}


def _norm_pass(layers):
    """The RMSNorm forward launches of one Llama forward pass: two a layer
    and the final norm."""
    return 2 * layers + 1


def _lora_step_want(layers, remat=True, on_card=True):
    """One LoRA step's launches on the card (zeros off it): the flash
    kernels' two forwards a layer (the backward replays it) and a dQ and
    dK/dV; the norms' forward pass, the layers' again under remat, and a
    backward for each but layer 0's attention norm (it reads the frozen
    embedding); no dscale (the norms' scales are frozen)."""
    want = {"fwd": 2 * layers, "bwd_dq": layers, "bwd_dkv": layers,
            "norm_fwd": _norm_pass(layers) + (2 * layers if remat else 0), "norm_bwd": 2 * layers, "norm_dscale": 0}
    return want if on_card else dict.fromkeys(want, 0)


# The tensor-core kernels of each source: each of their 4 instantiations
# (head dim 64/128 x bf16/f32 output) must hold wgmma and TMA loads.
TENSOR_CORE_KERNELS = {
    "flash_fwd": ("flash_fwd_wgmma",),
    "flash_bwd": ("flash_bwd_dkv_wgmma", "flash_bwd_dq_wgmma"),
}


def _cuda_tool(name):
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return shutil.which(name) or os.path.join(cuda_home, "bin", name)


def _demangle(names):
    try:
        out = subprocess.run([_cuda_tool("cu++filt"), *names], capture_output=True,
                             text=True, check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return {n: n for n in names}
    return dict(zip(names, out)) if len(out) == len(names) else {n: n for n in names}


def _ptxas_info(log):
    """Per kernel function: (registers, spill store bytes, spill load bytes)."""
    info, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            info[name] = [None, int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name in info:
            info[name][0] = int(m.group(1))
    return info


def _sass_counts(lib_path):
    """Per kernel function: its HGMMA and UTMALDG instructions (cuobjdump -sass)."""
    sass = subprocess.run([_cuda_tool("cuobjdump"), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = {"HGMMA": 0, "UTMALDG": 0}
        elif name:
            for op in counts[name]:
                counts[name][op] += op in line
    return counts


def phase_build():
    names = ("flash_fwd", "flash_bwd", "fold_fma", "rms_norm")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source, together
        paths = list(pool.map(_build.build, names))
    _build.flash_fwd_lib()
    _build.flash_bwd_lib()
    _build.fold_lib()
    _build.rms_norm_lib()
    built = ", ".join(f"{n} -> {p.name}" for n, p in zip(names, paths))
    print(f"[build] {built} in {time.perf_counter() - t0:.2f} s")
    for name, path in zip(names, paths):
        log = _build.log_path(name)
        log = log.read_text() if log.exists() else ""
        for line in log.splitlines():
            if "warning" in line:
                print(f"[build]   {name}: {line.strip()[:200]}")
        ptxas = _ptxas_info(log)
        sass = _sass_counts(path)
        readable = _demangle(sorted(sass))
        for fn in sorted(sass):
            regs, spill_st, spill_ld = ptxas.get(fn, (None, None, None))
            print(f"[build]   {name}: {readable[fn][:110]}: {regs} registers, spill stores "
                  f"{spill_st} B, spill loads {spill_ld} B, HGMMA {sass[fn]['HGMMA']}, "
                  f"UTMALDG {sass[fn]['UTMALDG']}")
        for kernel in TENSOR_CORE_KERNELS.get(name, ()):
            fns = [fn for fn in sass if kernel in fn]
            if len(fns) != 4:
                raise AssertionError(f"expected 4 instantiations of {kernel}, got {len(fns)}")
            for fn in fns:
                if not (sass[fn]["HGMMA"] and sass[fn]["UTMALDG"]):
                    raise AssertionError(f"{readable[fn]} has no HGMMA or no UTMALDG: {sass[fn]}")


def _qkv(gen, bh, t_q, t_k, d, dtype):
    def rand(t):
        return torch.randn(bh, t, d, generator=gen, device="cuda").to(dtype)

    return rand(t_q), rand(t_k), rand(t_k)


def phase_kernel_vs_plain(gen):
    """Returns the max abs error on o at the main path's shape."""
    bh = BATCH * 32
    cases = [
        # name, bh, t_q, t_k, d, dtype, out_dtype, causal, q_offset, kv_offset, window
        ("slice_causal", bh, 2048, 2048, 128, torch.bfloat16, None, True, 0, 0, None),
        ("causal_window512", bh, 2048, 2048, 128, torch.bfloat16, None, True, 0, 0, 512),
        ("offsets_masked_rows", 32, 1024, 1536, 128, torch.bfloat16, None, True, 128, 384, None),
        ("ragged_T1000", bh, 1000, 1000, 128, torch.bfloat16, None, True, 0, 0, None),
        ("d64", bh, 2048, 2048, 64, torch.bfloat16, None, True, 0, 0, None),
        ("f32_in_f32_out", 32, 1024, 1024, 128, torch.float32, torch.float32, True, 0, 0, None),
        ("bert_base", BERT_BH, SPLIT_LEN, SPLIT_LEN, 64, torch.bfloat16, None, False, 0, 0, None),
        *RING_STEP_CASES,
    ]
    slice_err = None
    for name, bh_, t_q, t_k, d, dtype, out_dtype, causal, q_off, kv_off, window in cases:
        q, k, v = _qkv(gen, bh_, t_q, t_k, d, dtype)
        kw = dict(scale=d**-0.5, causal=causal, q_offset=q_off, kv_offset=kv_off,
                  out_dtype=out_dtype, window=window)
        o, lse = _flash_forward(q, k, v, **kw)
        torch.cuda.synchronize()
        o_ref, lse_ref = _flash_forward_reference(q, k, v, **kw)
        tol = TOL.get((dtype, out_dtype), TOL[dtype])
        diff = (o.float() - o_ref.float()).abs()
        o_ok = bool(torch.all(diff <= tol["o_atol"] + tol["o_rtol"] * o_ref.float().abs()))
        lse_err = (lse - lse_ref).abs().max().item()
        masked = lse_ref <= NEG_INF / 2
        rows_ok = torch.equal(masked, lse <= NEG_INF / 2) and bool(torch.all(o[masked] == 0))
        abs_err = diff.max().item()
        rel_err = abs_err / o_ref.float().abs().max().item()
        print(
            f"[kernel] {name}: o max_abs_err={abs_err:.3e} max_rel_err={rel_err:.3e} "
            f"(tol {tol['o_atol']:g} + {tol['o_rtol']:g}*|ref|) lse max_abs_err={lse_err:.3e} "
            f"(tol {tol['lse_atol']:g}) fully_masked_rows={int(masked.sum())}"
        )
        if not (o_ok and lse_err <= tol["lse_atol"] and rows_ok and o.dtype == o_ref.dtype):
            raise AssertionError(f"flash_fwd disagrees with its plain version in case {name}")
        if name == "slice_causal":
            slice_err = abs_err
        if name == "bert_base":
            BERT_ERRS["fwd"] = abs_err
        del q, k, v, o, lse, o_ref, lse_ref, diff
        torch.cuda.empty_cache()
    return slice_err


def _seen_keys(t_q, t_k, causal, q_off, kv_off, window):
    """Which keys some query sees (the others must get dK = dV = 0)."""
    if not causal:
        return torch.ones(t_k, dtype=torch.bool, device="cuda")
    q_pos = q_off + torch.arange(t_q, device="cuda")[:, None]
    k_pos = kv_off + torch.arange(t_k, device="cuda")[None, :]
    vis = q_pos >= k_pos
    if window is not None:
        vis = vis & (q_pos - k_pos < window)
    return vis.any(dim=0)


def phase_bwd_kernel_vs_plain(gen):
    """Returns the max abs errors of dQ and of dK/dV at the training shape."""
    cases = [
        # name, bh, t_q, t_k, d, dtype, out_dtype, causal, q_offset, kv_offset, window
        ("slice_causal", 32, 2048, 2048, 128, torch.bfloat16, None, True, 0, 0, None),
        ("causal_window512", 32, 2048, 2048, 128, torch.bfloat16, None, True, 0, 0, 512),
        ("offsets_masked_rows", 32, 1024, 1536, 128, torch.bfloat16, None, True, 128, 384, None),
        ("ragged_T1000", 32, 1000, 1000, 128, torch.bfloat16, None, True, 0, 0, None),
        ("d64", 32, 2048, 2048, 64, torch.bfloat16, None, True, 0, 0, None),
        ("f32_in_f32_out", 32, 1024, 1024, 128, torch.float32, torch.float32, True, 0, 0, None),
        ("bf16_in_f32_out", 32, 2048, 2048, 128, torch.bfloat16, torch.float32, True, 0, 0, None),
        ("bert_base", BERT_BH, SPLIT_LEN, SPLIT_LEN, 64, torch.bfloat16, None, False, 0, 0, None),
        *(case for case in RING_STEP_CASES if case[0] != "zigzag_half_causal"),  # = bf16_in_f32_out
    ]
    slice_err = None
    for name, bh, t_q, t_k, d, dtype, out_dtype, causal, q_off, kv_off, window in cases:
        q, k, v = _qkv(gen, bh, t_q, t_k, d, dtype)
        do = torch.randn(bh, t_q, d, generator=gen, device="cuda").to(dtype)
        kw = dict(scale=d**-0.5, causal=causal, q_offset=q_off, kv_offset=kv_off, window=window)
        o, lse = _flash_forward(q, k, v, **kw)
        grads = _flash_backward(q, k, v, o, lse, do, out_dtype=out_dtype, **kw)
        torch.cuda.synchronize()
        refs = _flash_backward_reference(q, k, v, o, lse, do, out_dtype=out_dtype, **kw)
        frac, rtol = BWD_TOL[dtype]
        errs, ok = {}, True
        for gname, got, ref in zip(("dq", "dk", "dv"), grads, refs):
            ref32 = ref.float()
            diff = (got.float() - ref32).abs()
            span = ref32.abs().max()
            ok = ok and got.dtype == ref.dtype and bool(torch.all(diff <= frac * span + rtol * ref32.abs()))
            errs[gname] = (diff.max().item(), (diff.max() / span).item())
        dq, dk, dv = grads
        masked_rows = lse <= NEG_INF / 2
        unseen = ~_seen_keys(t_q, t_k, causal, q_off, kv_off, window)
        zeros_ok = (bool(torch.all(dq[masked_rows] == 0)) and bool(torch.all(dk[:, unseen] == 0))
                    and bool(torch.all(dv[:, unseen] == 0)))
        print(f"[bwd kernel] {name}: " + " ".join(
            f"{g} max_abs_err={a:.3e} (rel {r:.2e})" for g, (a, r) in errs.items())
            + f" (tol {frac:g}*max|ref| + {rtol:g}*|ref|) exact zeros: {int(masked_rows.sum())} "
            f"fully masked q rows, {int(unseen.sum()) * bh} unseen keys, ok={zeros_ok}")
        if not (ok and zeros_ok):
            raise AssertionError(f"flash backward kernels disagree with the plain version in case {name}")
        if name == "slice_causal":
            slice_err = {"dq": errs["dq"][0], "dkv": max(errs["dk"][0], errs["dv"][0])}
        if name == "bert_base":
            BERT_ERRS.update(dq=errs["dq"][0], dkv=max(errs["dk"][0], errs["dv"][0]))
        del q, k, v, do, o, lse, grads, refs, dq, dk, dv
        torch.cuda.empty_cache()
    return slice_err


def phase_slice(gen):
    cfg = llama.llama3_8b(param_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = llama.init_llama(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(w.numel() for w in params["layers"].values()) + sum(
        params[k].numel() for k in ("embed", "final_norm", "lm_head")
    )
    print(f"[slice] llama3_8b: {n_params / 1e9:.3f}e9 bf16 params initialised in "
          f"{time.perf_counter() - t0:.1f} s")
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN), generator=gen, device="cuda")

    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    out = llama.generate(params, cfg, prompts, NEW_TOKENS, attn_fn=flash_attention)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    launches = flash_attention.fwd_launches
    # The prefill and NEW_TOKENS - 1 decode steps: a forward pass each.
    norms = {k: v for k, v in _counts().items() if k in NORM_KEYS}
    want_norms = {"norm_fwd": NEW_TOKENS * _norm_pass(cfg.num_layers), "norm_bwd": 0, "norm_dscale": 0}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[slice] generate B={BATCH} T0={PROMPT_LEN} new={NEW_TOKENS}: {generate_s * 1e3:.1f} ms "
          f"(first call), flash_fwd launches={launches}, norms={norms}, max_memory_allocated={peak_gb:.2f} GB")
    if launches != cfg.num_layers or norms != want_norms:
        raise AssertionError(f"expected {cfg.num_layers} flash_fwd launches and norms {want_norms}, got "
                             f"{launches}, {norms}")
    if out.shape != (BATCH, PROMPT_LEN + NEW_TOKENS) or not torch.equal(out[:, :PROMPT_LEN], prompts):
        raise AssertionError(f"generate returned {tuple(out.shape)} or altered the prompt")
    new = out[:, PROMPT_LEN:]
    if not bool(torch.all((new >= 0) & (new < cfg.vocab_size))):
        raise AssertionError("generated token ids out of range")

    # Steady-state split: prefill alone, then the decode steps.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, logits = llama.prefill(params, cfg, prompts, PROMPT_LEN + NEW_TOKENS,
                                  attn_fn=flash_attention)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    if not bool(torch.isfinite(logits).all()) or logits.shape != (BATCH, cfg.vocab_size):
        raise AssertionError("prefill logits are not finite [B, V]")
    step = llama.make_decode_step(cfg)
    token = logits.argmax(dim=-1)
    t0 = time.perf_counter()
    for i in range(NEW_TOKENS):
        cache, logits = step(params, cache, token, PROMPT_LEN + i)
        token = logits.argmax(dim=-1)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / NEW_TOKENS
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("decode logits are not finite")
    print(f"[slice] prefill {prefill_ms:.1f} ms ({BATCH * PROMPT_LEN / prefill_ms * 1e3:.0f} prompt tok/s); "
          f"decode {decode_ms:.2f} ms/token step ({BATCH * 1e3 / decode_ms:.1f} tok/s at B={BATCH})")
    cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
    del cache, logits

    one = prompts[:1]
    _, via_flash = llama.prefill(params, cfg, one, PROMPT_LEN, attn_fn=flash_attention)
    _, via_dense = llama.prefill(params, cfg, one, PROMPT_LEN, attn_fn=dot_product_attention)
    gap = (via_flash - via_dense).abs().max().item()
    span = via_dense.abs().max().item()
    same_top = bool(torch.equal(via_flash.argmax(-1), via_dense.argmax(-1)))
    print(f"[slice] B=1 prefill logits, flash vs dense: max_abs_diff={gap:.4e} "
          f"max|logit|={span:.4e} (tol {LOGIT_REL_TOL:g}*max|logit|), same argmax={same_top}")
    if not gap <= LOGIT_REL_TOL * span:
        raise AssertionError("flash prefill logits disagree with the dense path")
    del params
    torch.cuda.empty_cache()
    return dict(launches=launches, norms=norms, prefill_ms=prefill_ms, decode_ms=decode_ms,
                cache_bytes=cache_bytes, peak_gb=peak_gb)


def phase_train(gen):
    """The training slice: LoRA Adam steps of Llama-3-8B through the kernels."""
    cfg = llama.llama3_8b(param_dtype=torch.bfloat16, remat=True)
    t0 = time.perf_counter()
    params = llama.init_llama(cfg, gen, device="cuda")
    lcfg = lora.LoraConfig(rank=LORA_RANK, targets=(r"w[qv]$",))
    adapters = lora.init_lora(params, lcfg, gen, device="cuda")
    opt = llama.init_adam(adapters)
    ids = torch.randint(0, cfg.vocab_size, (1, TRAIN_LEN), generator=gen, device="cuda")
    scales = {n: e["scale"].clone() for n, e in adapters["layers"].items()}
    step = llama.make_lora_train_step(cfg, lr=TRAIN_LR, attn_fn=flash_attention)
    torch.cuda.synchronize()
    print(f"[train] llama3_8b bf16 base, remat, LoRA rank {LORA_RANK} on w[qv] "
          f"({lora.num_lora_params(adapters) / 1e6:.3f}e6 adapter params), B=1 T={TRAIN_LEN}, "
          f"lr={TRAIN_LR:g}: set up in {time.perf_counter() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    want = _lora_step_want(cfg.num_layers, cfg.remat)
    losses, step_ms = [], []
    _zero_counts()
    for i in range(TRAIN_STEPS):
        before = _counts()
        t0 = time.perf_counter()
        adapters, opt, loss = step(adapters, opt, params, ids)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        per_step = {n: c - before[n] for n, c in _counts().items()}
        print(f"[train] step {i}: loss={losses[-1]:.6f} {step_ms[-1]:.1f} ms launches={per_step}")
        if per_step != want:
            raise AssertionError(f"step {i}: expected launches {want}, got {per_step}")
        if not torch.isfinite(loss):
            raise AssertionError(f"step {i}: loss is not finite")
    launches = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steady_ms = sum(step_ms[1:]) / (TRAIN_STEPS - 1)
    print(f"[train] {TRAIN_STEPS} steps: launches={launches}; steady step {steady_ms:.1f} ms "
          f"(steps 1-{TRAIN_STEPS - 1}; step 0 {step_ms[0]:.1f} ms), "
          f"{TRAIN_LEN / steady_ms * 1e3:.0f} tokens/s, max_memory_allocated={peak_gb:.2f} GB")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if not all(torch.equal(adapters["layers"][n]["scale"], s) for n, s in scales.items()):
        raise AssertionError("an adapter scale moved")
    del params, adapters, opt
    torch.cuda.empty_cache()
    return dict(launches=launches, steady_ms=steady_ms, step_ms=step_ms, losses=losses, peak_gb=peak_gb)


def phase_grad_check(gen):
    """Adapter gradients through the kernels vs through dense attention."""
    cfg = llama.llama3_8b(param_dtype=torch.bfloat16, num_layers=GRAD_CHECK_LAYERS)
    params = llama.init_llama(cfg, gen, device="cuda")
    adapters = lora.init_lora(params, lora.LoraConfig(rank=LORA_RANK), gen, device="cuda")
    for entry in adapters["layers"].values():  # B != 0, or dL/dA is exactly 0
        entry["b"] = 0.01 * torch.randn(entry["b"].shape, generator=gen, device="cuda")
    ids = torch.randint(0, cfg.vocab_size, (1, TRAIN_LEN), generator=gen, device="cuda")
    out = {}
    for name, fn in (("flash", flash_attention), ("dense", dot_product_attention)):
        out[name] = llama._value_and_grad(llama._lora_loss(cfg, fn), adapters, params, ids)
    worst = 0.0
    for target in adapters["layers"]:
        for leaf in ("a", "b"):
            g_flash = out["flash"][1]["layers"][target][leaf]
            g_dense = out["dense"][1]["layers"][target][leaf]
            gap = (g_flash - g_dense).abs().max().item()
            span = g_dense.abs().max().item()
            worst = max(worst, gap / span)
            print(f"[grads] depth {GRAD_CHECK_LAYERS} B=1 T={TRAIN_LEN}: d{target}.{leaf} flash vs dense "
                  f"max_abs_diff={gap:.4e} max|g_dense|={span:.4e} (tol {GRAD_REL_TOL:g}*max|g|)")
            if not (span > 0 and gap <= GRAD_REL_TOL * span):
                raise AssertionError(f"adapter gradient d{target}.{leaf} through flash disagrees with dense")
    print(f"[grads] loss flash={out['flash'][0].item():.6f} dense={out['dense'][0].item():.6f}; "
          f"worst gap {worst:.4f} of max|g|")
    del params, adapters, out
    torch.cuda.empty_cache()


# The int8 serving path: Llama-3-8B on an int8 base with the int8 KV cache
# and a sliding window below the prompt length, so the prefill's flash
# kernel skips out-of-band tiles and the decode wraps a ring of W slots.
SERVE_WINDOW = 1024
# Rolling vs linear int8 decode on the same tokens: the ring holds the same
# window in another slot order, so attention sums in another order; the gap
# is held to LOGIT_REL_TOL of the logits' range, and the greedy choices must
# agree in at least this share of (step, sequence) pairs.
ROLL_ARGMAX_AGREE = 0.9
# The int8 KV cache against the bf16 one: int8 codes plus an f32 scale per
# (position, head) over head dim 128 is (128 + 4) / 256 of the bytes.
INT8_CACHE_RATIO = 0.53
# The int8 training step's peak memory must be this far below the bf16
# step's: the int8 base saves ~7.5 GB, and keeping a dequantized copy of
# every layer's weights alive would eat that.
INT8_TRAIN_SAVING_GB = 5.0


def phase_serve_int8(gen, bf16):
    """The int8 serving path: int8 weights, int8 KV cache, rolling decode."""
    from rayfed_tpu_torch.models.quant import tree_nbytes

    cfg = llama.llama3_8b(param_dtype=torch.bfloat16, kv_quant=True, sliding_window=SERVE_WINDOW)
    t0 = time.perf_counter()
    params = llama.init_llama_int8(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    base_gb = tree_nbytes(params) / 1e9
    print(f"[serve_int8] llama3_8b int8 base ({base_gb:.3f} GB: int8 layers and head, bf16 embed), "
          f"kv_quant, window {SERVE_WINDOW}: initialised in {time.perf_counter() - t0:.1f} s")
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN), generator=gen, device="cuda")
    max_len = PROMPT_LEN + NEW_TOKENS

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    cache, logits = llama.prefill(params, cfg, prompts, max_len, attn_fn=flash_attention)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = flash_attention.fwd_launches
    norms = {k: v for k, v in _counts().items() if k in NORM_KEYS}
    want_norms = {"norm_fwd": _norm_pass(cfg.num_layers), "norm_bwd": 0, "norm_dscale": 0}
    if launches != cfg.num_layers or norms != want_norms:
        raise AssertionError(f"expected {cfg.num_layers} flash_fwd launches and norms {want_norms}, got "
                             f"{launches}, {norms}")
    if cache["k"].dtype != torch.int8 or not bool(torch.isfinite(logits).all()):
        raise AssertionError("the int8 prefill gave no int8 cache or non-finite logits")
    t0 = time.perf_counter()
    cache, logits = llama.prefill(params, cfg, prompts, max_len, attn_fn=flash_attention)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
    bf16_bytes = 2 * cache["k"].numel() * 2
    ratio = cache_bytes / bf16_bytes
    print(f"[serve_int8] prefill B={BATCH} T0={PROMPT_LEN}: flash_fwd launches={launches}, norms={norms}; "
          f"{prefill_ms:.1f} ms ({first_ms:.1f} ms first call); int8 cache {cache_bytes / 1e6:.2f} MB "
          f"for {max_len} slots = {ratio:.4f} of the bf16 cache's {bf16_bytes / 1e6:.2f} MB")
    if ratio > INT8_CACHE_RATIO:
        raise AssertionError(f"int8 cache at {ratio:.4f} of the bf16 cache's bytes (limit {INT8_CACHE_RATIO})")

    # The linear int8 decode, then the rolling one on the same tokens.
    ring = llama.roll_kv_cache(cache, cfg, PROMPT_LEN)
    ring_bytes = sum(t.numel() * t.element_size() for t in ring.values())
    first = logits.argmax(dim=-1)
    tokens, lin_logits = [first], []
    step = llama.make_decode_step(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(NEW_TOKENS):
        cache, out = step(params, cache, tokens[-1], PROMPT_LEN + i)
        lin_logits.append(out)
        tokens.append(out.argmax(dim=-1))
    torch.cuda.synchronize()
    linear_ms = (time.perf_counter() - t0) * 1e3 / NEW_TOKENS
    roll = llama.make_decode_step(cfg, rolling=True)
    gaps, agree = [], 0
    roll_ms = 0.0
    for i in range(NEW_TOKENS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ring, out = roll(params, ring, tokens[i], PROMPT_LEN + i)
        torch.cuda.synchronize()
        roll_ms += (time.perf_counter() - t0) * 1e3
        ref = lin_logits[i]
        gaps.append((out - ref).abs().max().item() / ref.abs().max().item())
        agree += int((out.argmax(dim=-1) == ref.argmax(dim=-1)).sum())
    roll_ms /= NEW_TOKENS
    share = agree / (NEW_TOKENS * BATCH)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[serve_int8] decode {NEW_TOKENS} steps at B={BATCH} over positions {PROMPT_LEN}.."
          f"{PROMPT_LEN + NEW_TOKENS - 1}: linear {linear_ms:.2f} ms/step, rolling {roll_ms:.2f} ms/step "
          f"(ring {ring_bytes / 1e6:.2f} MB, {SERVE_WINDOW} slots); rolling vs linear max|dlogit|/max|logit| "
          f"{max(gaps):.4e} (tol {LOGIT_REL_TOL:g}), same greedy token in {share:.4f} "
          f"(need {ROLL_ARGMAX_AGREE:g}); max_memory_allocated={peak_gb:.2f} GB")
    if not max(gaps) <= LOGIT_REL_TOL or share < ROLL_ARGMAX_AGREE:
        raise AssertionError("the rolling int8 decode disagrees with the linear one")
    del cache, ring, lin_logits, logits

    one = prompts[:1]
    _, via_flash = llama.prefill(params, cfg, one, PROMPT_LEN, attn_fn=flash_attention)
    _, via_dense = llama.prefill(params, cfg, one, PROMPT_LEN, attn_fn=dot_product_attention)
    gap = (via_flash - via_dense).abs().max().item()
    span = via_dense.abs().max().item()
    print(f"[serve_int8] B=1 prefill logits, flash vs dense (window {SERVE_WINDOW}): max_abs_diff={gap:.4e} "
          f"max|logit|={span:.4e} (tol {LOGIT_REL_TOL:g}*max|logit|)")
    if not gap <= LOGIT_REL_TOL * span:
        raise AssertionError("int8 flash prefill logits disagree with the dense path")
    print(f"[serve_int8] against the bf16 path (phase_slice, causal, bf16 cache): prefill "
          f"{prefill_ms:.1f} vs {bf16['prefill_ms']:.1f} ms; decode {roll_ms:.2f} (rolling) / "
          f"{linear_ms:.2f} (linear) vs {bf16['decode_ms']:.2f} ms/step; cache {cache_bytes / 1e6:.2f} vs "
          f"{bf16['cache_bytes'] / 1e6:.2f} MB; peak {peak_gb:.2f} vs {bf16['peak_gb']:.2f} GB")
    del params, prompts
    torch.cuda.empty_cache()
    return dict(launches=launches, norms=norms, prefill_ms=prefill_ms, linear_ms=linear_ms, rolling_ms=roll_ms,
                cache_bytes=cache_bytes, peak_gb=peak_gb)


def phase_train_int8(gen, bf16):
    """BASELINE config #4 as bench_lora_8b runs it: LoRA over an int8 base."""
    cfg = llama.llama3_8b(param_dtype=torch.bfloat16, remat=True)
    t0 = time.perf_counter()
    params = llama.init_llama_int8(cfg, gen, device="cuda")
    adapters = lora.init_lora(params, lora.LoraConfig(rank=LORA_RANK, targets=(r"w[qv]$",)), gen, device="cuda")
    opt = llama.init_adam(adapters)
    ids = torch.randint(0, cfg.vocab_size, (1, TRAIN_LEN), generator=gen, device="cuda")
    scales = {n: e["scale"].clone() for n, e in adapters["layers"].items()}
    step = llama.make_lora_train_step(cfg, lr=TRAIN_LR, attn_fn=flash_attention)
    torch.cuda.synchronize()
    print(f"[train_int8] llama3_8b int8 base, remat, LoRA rank {LORA_RANK} on w[qv] "
          f"({lora.num_lora_params(adapters) / 1e6:.3f}e6 adapter params), B=1 T={TRAIN_LEN}, "
          f"lr={TRAIN_LR:g}: set up in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    want = _lora_step_want(cfg.num_layers, cfg.remat)
    losses, step_ms = [], []
    _zero_counts()
    for i in range(TRAIN_STEPS):
        before = _counts()
        t0 = time.perf_counter()
        adapters, opt, loss = step(adapters, opt, params, ids)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        per_step = {n: c - before[n] for n, c in _counts().items()}
        print(f"[train_int8] step {i}: loss={losses[-1]:.6f} {step_ms[-1]:.1f} ms launches={per_step}")
        if per_step != want:
            raise AssertionError(f"int8 step {i}: expected launches {want}, got {per_step}")
        if not torch.isfinite(loss):
            raise AssertionError(f"int8 step {i}: loss is not finite")
    launches = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steady_ms = sum(step_ms[1:]) / (TRAIN_STEPS - 1)
    print(f"[train_int8] {TRAIN_STEPS} steps: launches={launches}; steady step {steady_ms:.1f} ms "
          f"({TRAIN_LEN / steady_ms * 1e3:.0f} tokens/s; bf16 base {bf16['steady_ms']:.1f} ms, "
          f"{TRAIN_LEN / bf16['steady_ms'] * 1e3:.0f} tokens/s), max_memory_allocated={peak_gb:.2f} GB "
          f"(bf16 base {bf16['peak_gb']:.2f} GB, saving {bf16['peak_gb'] - peak_gb:.2f} GB, "
          f"need {INT8_TRAIN_SAVING_GB:g})")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the int8-base loss did not fall: {losses}")
    if not all(torch.equal(adapters["layers"][n]["scale"], s) for n, s in scales.items()):
        raise AssertionError("an adapter scale moved")
    if not peak_gb <= bf16["peak_gb"] - INT8_TRAIN_SAVING_GB:
        raise AssertionError(f"int8-base step peak {peak_gb:.2f} GB is not {INT8_TRAIN_SAVING_GB:g} GB "
                             f"below the bf16 step's {bf16['peak_gb']:.2f} GB")
    del params, adapters, opt
    torch.cuda.empty_cache()
    return dict(launches=launches, steady_ms=steady_ms, step_ms=step_ms, losses=losses, peak_gb=peak_gb)


def _bound(flops, nbytes, card):
    kind, (flops_peak, bytes_peak) = _peaks(card)
    flop_ms, byte_ms = flops / flops_peak * 1e3, nbytes / bytes_peak * 1e3
    return (flop_ms, "operations") if flop_ms >= byte_ms else (byte_ms, "bytes")


def phase_bwd_times(gen, card):
    """dQ and dK/dV at the training shape vs plain, SDPA's backward, the bound."""
    b, h, t, d = 1, 32, TRAIN_LEN, 128
    q, k, v = _qkv(gen, b * h, t, t, d, torch.bfloat16)
    do = torch.randn(b * h, t, d, generator=gen, device="cuda").to(torch.bfloat16)
    kw = dict(scale=d**-0.5, causal=True)
    o, lse = _flash_forward(q, k, v, **kw)
    lse, delta = _lse_delta(o, lse, do)
    inputs = (q, k, v, do, lse, delta)
    dq_ms = _sync_ms(lambda: _flash_bwd_dq(*inputs, **kw), iters=20)
    dq_host_us = _host_us(lambda: _flash_bwd_dq(*inputs, **kw))
    dkv_ms = _sync_ms(lambda: _flash_bwd_dkv(*inputs, **kw), iters=20)
    dq_plain = _sync_ms(lambda: _flash_bwd_dq_reference(*inputs, **kw), iters=5)
    dkv_plain = _sync_ms(lambda: _flash_bwd_dkv_reference(*inputs, **kw), iters=5)
    # SDPA's backward (all three gradients, one call): fwd+bwd minus fwd.
    q4, k4, v4 = (x.view(b, h, t, d).clone().requires_grad_(True) for x in (q, k, v))
    g4 = do.view(b, h, t, d)

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)

    sdpa_fwd = _sync_ms(sdpa, iters=20)
    sdpa_fwd_bwd = _sync_ms(lambda: torch.autograd.grad(sdpa(), (q4, k4, v4), g4), iters=20)
    sdpa_bwd = sdpa_fwd_bwd - sdpa_fwd
    mm = 2 * b * h * d * (t * (t + 1) // 2)  # one causal T×T×D product
    elem = b * h * t * d * 2  # one bf16 [BH, T, D] tensor
    rows = 2 * b * h * t * 4  # lse + delta, f32
    out = {}
    for name, ms, plain, n_mm, n_io in (("dq", dq_ms, dq_plain, 3, 5), ("dkv", dkv_ms, dkv_plain, 4, 6)):
        bound_ms, bound_by = _bound(n_mm * mm, n_io * elem + rows, card)
        tflops = n_mm * mm / ms / 1e9
        out[name] = dict(ms=ms, plain_ms=plain, bound_ms=bound_ms, bound_by=bound_by, library_ms=sdpa_bwd,
                         tflops=tflops, bound_share=bound_ms / ms)
        print(f"[times] flash_bwd_{name} B={b} H={h} T={t} D={d} causal bf16: kernel {ms:.3f} ms, "
              f"plain {plain:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}; {n_mm} products, "
              f"{(n_io * elem + rows) / 1e6:.1f} MB), {tflops:.1f} TFLOP/s achieved, "
              f"{bound_ms / ms:.3f} of the bound")
    out["dq"]["host_us"] = dq_host_us
    print(f"[times] sdpa backward (dq, dk, dv in one call) {sdpa_bwd:.3f} ms "
          f"(fwd+bwd {sdpa_fwd_bwd:.3f} - fwd {sdpa_fwd:.3f}); kernels dq+dkv {dq_ms + dkv_ms:.3f} ms; "
          f"host {dq_host_us:.1f} us per call to enqueue dq")
    return out


def _fwd_times(gen, card, b):
    h, t, d = 32, PROMPT_LEN, 128
    q, k, v = _qkv(gen, b * h, t, t, d, torch.bfloat16)
    scale = d**-0.5
    ms = _sync_ms(lambda: _flash_forward(q, k, v, scale=scale, causal=True), iters=20)
    host_us = _host_us(lambda: _flash_forward(q, k, v, scale=scale, causal=True))
    plain_ms = _sync_ms(lambda: _flash_forward_reference(q, k, v, scale=scale, causal=True), iters=5)
    q4, k4, v4 = (x.view(b, h, t, d) for x in (q, k, v))
    library_ms = _sync_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True), iters=20)
    pairs = t * (t + 1) // 2  # visible (q, k) pairs of one causal head
    flops = 4 * b * h * d * pairs  # Q·Kᵀ and P·V
    nbytes = 4 * b * h * t * d * 2 + b * h * t * 4  # q, k, v, o in bf16 + f32 lse
    bound_ms, bound_by = _bound(flops, nbytes, card)
    tflops = flops / ms / 1e9
    print(f"[times] flash_fwd B={b} H={h} T={t} D={d} causal bf16: kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, sdpa {library_ms:.3f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}; H100 {_peaks(card)[0]} peaks; {tflops:.1f} TFLOP/s achieved, "
          f"{bound_ms / ms:.3f} of the bound); host {host_us:.1f} us per call to enqueue it")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                tflops=tflops, bound_share=bound_ms / ms, host_us=host_us)


def phase_times(gen, card):
    """The forward at the serving shape (B=4) and at the training shape (B=1)."""
    serve = _fwd_times(gen, card, BATCH)
    return serve, _fwd_times(gen, card, 1)


def phase_bert_times(gen, card):
    """The three kernels at the split path's shape, bert_base's attention:
    [B·H = 32·12, T = 512, D = 64] bf16, non-causal, against their plain
    versions, SDPA and the bound.  A non-causal T×T×D product is 2·BH·T²·D
    operations; the forward does 2 (QKᵀ, PV), dQ 3 (QKᵀ, dO·Vᵀ, dS·K) and
    dK/dV 4 (QKᵀ, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q)."""
    b, h, t, d = SPLIT_BATCH, 12, SPLIT_LEN, 64
    q, k, v = _qkv(gen, b * h, t, t, d, torch.bfloat16)
    do = torch.randn(b * h, t, d, generator=gen, device="cuda").to(torch.bfloat16)
    kw = dict(scale=d**-0.5, causal=False)
    o, lse = _flash_forward(q, k, v, **kw)
    lse, delta = _lse_delta(o, lse, do)
    inputs = (q, k, v, do, lse, delta)
    ms = {"fwd": _sync_ms(lambda: _flash_forward(q, k, v, **kw), iters=20),
          "dq": _sync_ms(lambda: _flash_bwd_dq(*inputs, **kw), iters=20),
          "dkv": _sync_ms(lambda: _flash_bwd_dkv(*inputs, **kw), iters=20)}
    plain = {"fwd": _sync_ms(lambda: _flash_forward_reference(q, k, v, **kw), iters=5),
             "dq": _sync_ms(lambda: _flash_bwd_dq_reference(*inputs, **kw), iters=5),
             "dkv": _sync_ms(lambda: _flash_bwd_dkv_reference(*inputs, **kw), iters=5)}
    q4, k4, v4 = (x.view(b, h, t, d).clone().requires_grad_(True) for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4)

    sdpa_fwd = _sync_ms(sdpa, iters=20)
    sdpa_bwd = _sync_ms(lambda: torch.autograd.grad(sdpa(), (q4, k4, v4), do.view(b, h, t, d)),
                        iters=20) - sdpa_fwd
    mm = 2 * b * h * t * t * d
    elem = b * h * t * d * 2
    rows = b * h * t * 4
    out = {}
    for name, n_mm, nbytes, library in (("fwd", 2, 4 * elem + rows, sdpa_fwd),
                                        ("dq", 3, 5 * elem + 2 * rows, sdpa_bwd),
                                        ("dkv", 4, 6 * elem + 2 * rows, sdpa_bwd)):
        bound_ms, bound_by = _bound(n_mm * mm, nbytes, card)
        out[name] = dict(ms=ms[name], plain_ms=plain[name], bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=library, tflops=n_mm * mm / ms[name] / 1e9,
                         bound_share=bound_ms / ms[name], max_abs_err=BERT_ERRS[name],
                         shape=[b * h, t, d], causal=False)
        print(f"[times] bert_base {name} B={b} H={h} T={t} D={d} non-causal bf16: kernel {ms[name]:.4f} ms, "
              f"plain {plain[name]:.3f} ms, sdpa {library:.4f} ms{' (whole bwd)' if name != 'fwd' else ''}, "
              f"bound {bound_ms:.4f} ms ({bound_by}; {n_mm} products of {mm / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB), {n_mm * mm / ms[name] / 1e9:.1f} TFLOP/s, "
              f"{bound_ms / ms[name]:.3f} of the bound")
    return out


# The Llama RMSNorm's kernels at the Mistral-7B cell's shape: one local
# step's rows (B=1 x T=8192) of D=4096, bf16 activations and scale.
RMS_SHAPE, RMS_EPS = (8192, 4096), 1e-5


def phase_rms_norm(gen, card):
    """The RMSNorm kernels vs the model's formula as PyTorch ops (and
    autograd's backward of it), F.rms_norm as a yardstick only, and the
    bound: one read of x and one write of y forward; reads of x and dy and a
    write of dx backward (the f32 rstd a row beside them).  The host's time
    to enqueue a forward at Mistral's shape and at a decode step's [4, 1,
    4096], through the model's entry (``rms_norm.rms_norm``) and as the
    formula's ops."""
    rn = rms_norm_op
    rows, width = RMS_SHAPE
    bf = torch.bfloat16
    x = (3 * torch.randn(rows, width, generator=gen, device="cuda")).to(bf)
    scale = (1 + 0.5 * torch.randn(width, generator=gen, device="cuda")).to(bf)
    dy = torch.randn(rows, width, generator=gen, device="cuda").to(bf)
    y, rstd = rn._forward(x, scale, RMS_EPS, want_rstd=True)
    xg, sg = x.clone().requires_grad_(True), scale.clone().requires_grad_(True)
    y_p = rn.rms_norm_plain(xg, sg, RMS_EPS)
    dx_p, ds_p = torch.autograd.grad(y_p, (xg, sg), dy)
    dx, ds = rn._backward(dy, x, rstd, scale, want_dscale=True)
    torch.cuda.synchronize()
    gaps = {}  # the largest gap over the largest value
    for name, got, want in (("y", y, y_p.detach()), ("dx", dx, dx_p), ("dscale", ds, ds_p)):
        gap = (got.float() - want.float()).abs()
        gaps[name] = gap.max().item() / want.float().abs().max().item()
        print(f"[rms_norm] {name}: max gap {gap.max().item():.3e} ({gaps[name]:.2e} of the largest), "
              f"{(gap > 0).float().mean().item():.2e} of elements differ")
        if (gap > 2.0**-7 * want.float().abs() + 1e-4 * want.float().abs().max()).any():
            raise AssertionError(f"rms_norm {name} is off the formula by more than a bf16 step")

    nbytes = {"fwd": rows * width * 2 * 2 + rows * 4, "bwd": rows * width * 2 * 3 + rows * 4}
    fwd_ms = _sync_ms(lambda: rn._forward(x, scale, RMS_EPS, want_rstd=True), iters=20)
    bwd_ms = _sync_ms(lambda: rn._backward(dy, x, rstd, scale, want_dscale=False), iters=20)
    dscale_ms = _sync_ms(lambda: rn._backward(dy, x, rstd, scale, want_dscale=True), iters=20)
    # The formula's forward: the model's norm on the card before the kernels.
    plain_fwd = _sync_ms(lambda: rn.rms_norm_plain(x, scale, RMS_EPS), iters=20)
    xa = x.clone().requires_grad_(True)

    def fwd_bwd(norm):
        return _sync_ms(lambda: torch.autograd.grad(norm(xa), xa, dy), iters=20)

    # The model's backward before the kernels: autograd through the formula.
    plain_bwd = fwd_bwd(lambda t: rn.rms_norm_plain(t, scale, RMS_EPS)) - plain_fwd
    # F.rms_norm: a yardstick only; the port never calls it.
    lib_fwd = _sync_ms(lambda: F.rms_norm(x, (width,), scale, RMS_EPS), iters=20)
    lib_bwd = fwd_bwd(lambda t: F.rms_norm(t, (width,), scale, RMS_EPS)) - lib_fwd
    host_us = {}
    xd = x[:4].reshape(4, 1, width)
    with torch.no_grad():
        for shape, t, calls in (("mistral", x, 20), ("decode", xd, 100)):  # well inside the launch queue
            host_us[shape] = {"kernel": _host_us(lambda: rn.rms_norm(t, scale, RMS_EPS), calls=calls),
                              "plain": _host_us(lambda: rn.rms_norm_plain(t, scale, RMS_EPS), calls=calls)}
    out = {}
    for name, ms, plain, library in (("fwd", fwd_ms, plain_fwd, lib_fwd), ("bwd", bwd_ms, plain_bwd, lib_bwd)):
        bound_ms = nbytes[name] / _peaks(card)[1][1] * 1e3
        out[name] = dict(ms=ms, plain_ms=plain, bound_ms=bound_ms, bound_by="bytes", library_ms=library,
                         bound_share=bound_ms / ms, gbps=nbytes[name] / ms / 1e6,
                         max_gap=gaps["y" if name == "fwd" else "dx"])
        print(f"[times] rms_norm_{name} [{rows}, {width}] bf16: kernel {ms:.4f} ms "
              f"({nbytes[name] / ms / 1e6:.0f} GB/s), plain {plain:.4f} ms, F.rms_norm {library:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({nbytes[name] / 1e6:.1f} MB), {bound_ms / ms:.3f} of the bound")
    out["bwd"].update(dscale_ms=dscale_ms, max_gap_dscale=gaps["dscale"])
    out["fwd"]["host_us"] = host_us
    print(f"[times] rms_norm_bwd: with dscale (full-parameter training) {dscale_ms:.4f} ms; plain is autograd "
          f"through the formula")
    print(f"[times] rms_norm_fwd host us per call to enqueue (kernel vs the formula's ops): "
          + ", ".join(f"{k} {v['kernel']:.1f} vs {v['plain']:.1f}" for k, v in host_us.items()))
    return out


# -- the fold: the streaming aggregator alone, in this process ---------------

# Contributions of the fold phase: the round's packed adapters (rank-16
# w[qv] adapters of llama3_8b, a and b plus the two 0-d scales) and the
# stacked wq (32 x 4096 x 4096), both as bf16 wire buffers.
FOLD_SIZES = (("adapters", 2, 6_815_748), ("wq", 4, 32 * 4096 * 4096))
FOLD_WEIGHTS = (3, 5, 7, 11)
FOLD_PIECE = 512 * 1024  # bytes handed to a sink at a time
# The CPU's fold is held against the card's over at most this many
# elements: whole blocks spread evenly from the buffer's first to its last
# (the fold is elementwise and blockwise, so the same blocks of the inputs
# give the same blocks of the result; the whole of wq took the CPU 41 s a
# weighting).
FOLD_CPU_ELEMS = 1 << 24


def _cpu_blocks(elems, block):
    """The blocks of ``block`` elements the CPU's fold covers: all of them
    up to FOLD_CPU_ELEMS, else that many spread over the buffer, its first
    and its last block (which may be short) among them."""
    nb = -(-elems // block)
    k = max(1, FOLD_CPU_ELEMS // block)
    if nb <= k:
        return list(range(nb))
    return sorted({round(i * (nb - 1) / (k - 1)) for i in range(k)})


def _take_blocks(t, blocks, block):
    """The elements of ``blocks`` of the flat tensor ``t``, in order, as one
    tensor (a view when they are one run from the start)."""
    if blocks == list(range(len(blocks))):
        return t[:len(blocks) * block]
    return torch.cat([t[b * block:(b + 1) * block] for b in blocks])


def _payload_bytes(packed):
    """One contribution's wire payload as one writable buffer."""
    from rayfed_tpu_torch.transport import wire

    views = [memoryview(b).cast("B") for b in wire.encode_payload(packed)]
    out, off = bytearray(sum(v.nbytes for v in views)), 0
    for v in views:
        out[off:off + v.nbytes] = v
        off += v.nbytes
    return out


def _feed_interleaved(agg, payloads, order, rng):
    """Hand every payload to its sink in FOLD_PIECE pieces, the streams
    interleaved at random, as arrivals from several peers would."""
    sinks = {i: agg.sink(i) for i in order}
    pos = dict.fromkeys(order, 0)
    live = list(order)
    while live:
        i = rng.choice(live)
        p = payloads[i]
        pos[i] = min(len(p), pos[i] + FOLD_PIECE)
        if pos[i] == len(p):
            sinks[i].on_complete(p)
            live.remove(i)
        else:
            sinks[i].on_bytes(memoryview(p), pos[i])


def _raw(t):
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)


def _event_ms(fn):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


class _PlainFmaOff:
    """Within: ``ops.fold.fma_ftz``, the fold kernel's plain arithmetic, raises
    on a CUDA tensor, in every module that bound it (the fold's plain
    versions, the codec, the finalize's tail), so a run inside shows that no
    path of the card took it.  CPU tensors pass, for the comparisons."""

    BOUND = (("rayfed_tpu_torch.ops.fold", "fma_ftz"), ("rayfed_tpu_torch.ops.xla_cpu", "fma_ftz"))

    def __enter__(self):
        import importlib

        self.saved = []
        for name, attr in self.BOUND:
            mod = importlib.import_module(name)
            orig = getattr(mod, attr)

            def guard(a, b, c, out=None, _orig=orig):
                if any(isinstance(t, torch.Tensor) and t.is_cuda for t in (a, b, c, out)):
                    raise AssertionError("the fold's plain fma ran on a CUDA tensor")
                return _orig(a, b, c, out=out)

            setattr(mod, attr, guard)
            self.saved.append((mod, attr, orig))
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in self.saved:
            setattr(mod, attr, orig)
        return False


def _at(t, off):
    """``t`` as a view that starts ``off`` elements into a fresh buffer (an
    operand at any element offset, as a chunk of a wire frame is)."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    view = buf[off:off + t.numel()]
    view.copy_(t)
    return view


def _edges(n, gen):
    """Standard normals on the card with signed zeros, subnormals, small
    integers and ties mixed in."""
    x = torch.randn(n, generator=gen, device="cuda")
    edge = torch.tensor([0.0, -0.0, 1e-40, -3e-39, 1.0, -2.0, 2.0 ** -126, 3.0], device="cuda")
    x[: min(n, 8)] = edge[: min(n, 8)]
    return x


# The forms held against their plain versions: lengths and element offsets
# of the step and the pair, operand counts, wire and output types and
# weights of the chain (9 is past fold.MAX_OPS), and the rows form at the
# codec's block shapes (whole 2^21-element blocks, a short last block, the
# finalize tail's rows of one).  Operands at offsets no head aligns take the
# scalar kernel; every operand at one offset, the vector kernel after a head
# (the chain then at 1 to 9 operands, fractional weights).
FORM_LENGTHS = (1, 7, 8, (1 << 21) + 3)
FORM_CHAIN_K = (1, 2, 3, 4, 9)
FORM_HEAD_CHAIN_K = range(1, 10)
FORM_CHAIN_WEIGHTS = (None, (3, 5, 7, 11, 13, 2, 9, 4, 6), (1.7, 2.3, 0.9, 4.1, 0.3, 1.1, 2.9, 0.7, 3.3))
FORM_ROWS = ((3, 1 << 21), (1, 1_048_579), (4, 1))


def _fold_forms_vs_plain(gen):
    """Every form of ``csrc/fold_fma.cu`` against its plain version on the
    same card inputs, byte for byte, and the head each launch planned
    against the one its operands' offsets give; returns the largest
    |difference| (0 when all hold), the number of cases and the heads seen
    (-1: the scalar kernel)."""
    worst, cases, heads = 0.0, 0, set()

    def same(got, want, what):
        nonlocal worst, cases
        cases += 1
        if not torch.equal(_raw(got), _raw(want)):
            err = (got.float().cpu() - want.float().cpu()).abs().max().item()
            worst = max(worst, err)
            raise AssertionError(f"[fold forms] {what}: the kernel differs from its plain version (max |d| {err})")

    def head(got, want, what):
        heads.add(got)
        if got != want:
            raise AssertionError(f"[fold forms] {what}: the launch planned a head of {got}, not {want}")

    for wire in (torch.bfloat16, torch.float32):
        for n in FORM_LENGTHS:
            for off in range(8):
                x = _at(_edges(n, gen).to(wire), (off + 3) % 8)
                y = _at(_edges(n, gen).to(wire), off)
                acc = _at(_edges(n, gen), off)
                want = fold.step_plain(acc.clone(), 2.3, x)
                same(fold.fold_fma_(acc, 2.3, x), want, f"step {wire} n={n} offset {off}")
                same(fold.fold_fma_pair(-0.7, x, 1.9, y), fold.pair_plain(-0.7, x, 1.9, y),
                     f"pair {wire} n={n} offset {off}")
        for out in (torch.bfloat16, torch.float32):
            for k in FORM_CHAIN_K:
                xs = [_at(_edges(FORM_LENGTHS[-1], gen).to(wire), i % 8) for i in range(k)]
                for weights in FORM_CHAIN_WEIGHTS:
                    ws = [1.0] * k if weights is None else list(weights[:k])
                    before = fold.fold_fma_.by_form["chain"]
                    got = fold.fold_chain(xs, ws, float(sum(ws)), out)
                    if fold.fold_fma_.by_form["chain"] - before != -(-k // fold.MAX_OPS):
                        raise AssertionError(f"[fold forms] chain of {k}: "
                                             f"{fold.fold_fma_.by_form['chain'] - before} launches")
                    same(got, fold.chain_plain(xs, ws, float(sum(ws)), out),
                         f"chain k={k} {wire} -> {out} weights {weights and weights[:k]}")
                del xs
    for rows, width in FORM_ROWS:
        c = _edges(rows * width, gen).reshape(rows, width)
        sc = torch.rand(rows, 1, generator=gen, device="cuda") * 1e-2
        zp = torch.round(torch.randn(rows, 1, generator=gen, device="cuda") * 100)
        codes = torch.randint(0, 256, (rows, width), generator=gen, device="cuda", dtype=torch.uint8)
        for b in (codes, codes.float()):
            for negate in (False, True):
                for z in (zp, None):
                    same(fold.fma_rows(sc, b, c, z, negate=negate), fold.rows_plain(sc, b, c, z, negate=negate),
                         f"rows [{rows}, {width}] {b.dtype} negate {negate} zp {z is not None}")
    # Every operand at one element offset: the vector kernel after a head.
    for wire in (torch.bfloat16, torch.float32):
        unit = 16 // wire.itemsize
        for n in FORM_LENGTHS:
            for off in range(1, 8):
                x, y = (_at(_edges(n, gen).to(wire), off) for _ in range(2))
                acc = _at(_edges(n, gen), off)
                h = -off % unit
                what = f"{wire} n={n} all at offset {off}"
                head(fold.vector_head(x, acc), h, f"step {what}")
                want = fold.step_plain(acc.clone(), 2.3, x)
                same(fold.fold_fma_(acc, 2.3, x), want, f"step {what}")
                pair = fold.fold_fma_pair(-0.7, x, 1.9, y)
                head(fold.vector_head(x, y, pair), h if h % 4 == 0 else -1, f"pair {what}")
                same(pair, fold.pair_plain(-0.7, x, 1.9, y), f"pair {what}")
        xs = [_at(_edges(FORM_LENGTHS[-1], gen).to(wire), 4) for _ in range(max(FORM_HEAD_CHAIN_K))]
        for out in (torch.bfloat16, torch.float32):
            for k in FORM_HEAD_CHAIN_K:
                ws = list(FORM_CHAIN_WEIGHTS[2][:k])
                got = fold.fold_chain(xs[:k], ws, float(sum(ws)), out)
                what = f"chain k={k} {wire} -> {out} all at offset 4"
                head(fold.vector_head(*xs[:k], got), 0 if wire == torch.float32 else 4 if out == torch.float32
                     else -1, what)
                same(got, fold.chain_plain(xs[:k], ws, float(sum(ws)), out), what)
        del xs
    for rows, width in FORM_ROWS:
        c = _at(_edges(rows * width, gen), 4).reshape(rows, width)
        sc = torch.rand(rows, 1, generator=gen, device="cuda") * 1e-2
        zp = torch.round(torch.randn(rows, 1, generator=gen, device="cuda") * 100)
        codes = torch.randint(0, 256, (rows * width,), generator=gen, device="cuda", dtype=torch.uint8)
        for b in (codes, codes.float()):
            b = _at(b, 4).reshape(rows, width)
            for negate in (False, True):
                for z in (zp, None):
                    got = fold.fma_rows(sc, b, c, z, negate=negate)
                    what = f"rows [{rows}, {width}] {b.dtype} all at offset 4 negate {negate} zp {z is not None}"
                    head(fold.vector_head(b, c, got), 4 if b.element_size() == 1 else 0, what)
                    same(got, fold.rows_plain(sc, b, c, z, negate=negate), what)
    # The flush at 2^-126: operands whose products, FMAs and quotients
    # land within 64 ulps of it on both sides (some tiny, some rounding up
    # to it), subnormals beside them; every form, at both wires.
    for wire in (torch.bfloat16, torch.float32):
        for w in (2.3, -0.7, _f32(1 - 2 ** -24)):
            n = FORM_LENGTHS[-1]
            x, y = (_tiny_edges(n, w, gen).to(wire) for _ in range(2))
            acc = _tiny_edges(n, 1.0, gen)
            what = f"{wire} at the flush, weight {w}"
            same(fold.fold_fma_(acc.clone(), w, x), fold.step_plain(acc.clone(), w, x), f"step {what}")
            same(fold.fold_fma_pair(w, x, w, y), fold.pair_plain(w, x, w, y), f"pair {what}")
            for out in (torch.bfloat16, torch.float32):
                for k in (1, 2, 3):
                    xs = [x, y, x][:k]
                    same(fold.fold_chain(xs, [w] * k, 1.0, out), fold.chain_plain(xs, [w] * k, 1.0, out),
                         f"chain k={k} -> {out} {what}")
                same(fold.finalize(acc, 1.0 / w, out), fold.finalize_plain(acc, 1.0 / w, out),
                     f"finalize -> {out} {what}")
            rows = acc.reshape(-1)[: 4 * (n // 4)].reshape(4, -1)
            sc = torch.full((4, 1), abs(w), device="cuda")
            zp = torch.tensor([[0.0], [1e-40], [-0.0], [2.0 ** -126]], device="cuda")
            for negate in (False, True):
                same(fold.fma_rows(sc, rows.contiguous(), rows.contiguous(), zp, negate=negate),
                     fold.rows_plain(sc, rows.contiguous(), rows.contiguous(), zp, negate=negate),
                     f"rows {what} negate {negate}")
    # The binary form against ops/ftz.py's PyTorch ops on the host: the
    # products and quotients at the flush, sums of subnormals; b whole,
    # one value a row, one value, and the one value first.
    a = _tiny_edges(FORM_LENGTHS[-1], 1.0, gen).reshape(1, -1)
    ws = torch.tensor([[2.3], [-0.7], [_f32(1 - 2 ** -24)]], device="cuda")
    prods = torch.cat([_tiny_edges(FORM_LENGTHS[-1], float(w), gen).reshape(1, -1) for w in ws.reshape(-1)])
    quots = torch.cat([_tiny_edges(FORM_LENGTHS[-1], 1.0 / float(w), gen).reshape(1, -1) for w in ws.reshape(-1)])
    for op, x, y in (("mul", prods, ws), ("div", quots, 1.0 / ws), ("add", prods, a * 0.75), ("sub", prods, a)):
        for y_form in (y, y.expand_as(x).contiguous(), y.reshape(-1)[:1].reshape(())):
            fn = getattr(ftz, op)
            same(fn(x, y_form), fn(x.cpu(), y_form.cpu()), f"ftz {op} b {tuple(y_form.shape)}")
        same(getattr(ftz, op)(y.reshape(-1)[:1].reshape(()), x), getattr(ftz, op)(
            y.reshape(-1)[:1].reshape(()).cpu(), x.cpu()), f"ftz {op} a one value")
    torch.cuda.synchronize()
    return worst, cases, sorted(heads)


def _f32(v: float) -> float:
    """``v`` rounded to f32."""
    return torch.tensor(v, dtype=torch.float32).item()


def _tiny_edges(n, w, gen):
    """f32 operands on the card whose products with ``w`` sweep 2^-126 ± 64
    ulps in both signs, subnormals and signed zeros every 7th element."""
    k = torch.arange(n, device="cuda") % 129 - 64
    base = _f32(2.0 ** -126 / _f32(w))
    x = (base * (1 + k.double() * 2.0 ** -24)).float()
    x = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.5, x, -x)
    x[::7] = torch.tensor([1e-40, -3e-39, 0.0, -0.0, 1e-45, 2.0 ** -126, -5.9e-39], device="cuda").repeat(n)[: x[::7].numel()]
    return x


def _peak_mb(fn):
    """``fn()``'s result and the most device memory, in MB, that was
    allocated at once during it beyond what was allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 1e6


def _busy(fn):
    """The card's busy share over one call of ``fn``, from a torch.profiler
    trace: its kernels' device ms over the call's wall ms, and their
    launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return {"wall_ms": wall_ms, "kernel_ms": kernel_ms, "busy_share": kernel_ms / wall_ms,
            "launches": sum(e.count for e in kernels)}


def _launch_device_us(fn, calls=20):
    """Device µs per launch of ``fn``: the launches are queued behind a spin
    of the card, so the events around them time the card's work and not the
    host's enqueue."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # ~25 ms: longer than enqueueing the calls
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls * 1e3


def phase_fold(gen, card):
    """The streaming fold on the card against the CPU fold, every form of
    the fold kernel against its plain version, and their times."""
    import random

    _, (_, hbm) = _peaks(card)
    rng = random.Random(SEED)
    times = {}
    t0 = time.perf_counter()
    forms_err, forms_cases, forms_heads = _fold_forms_vs_plain(gen)
    print(f"[fold forms] step and pair at lengths {FORM_LENGTHS} and element offsets 0-7, chain of "
          f"{FORM_CHAIN_K} operands (bf16 and f32 wire and output, weights 1s, integers, fractions; "
          f"fold.MAX_OPS {fold.MAX_OPS} a launch), rows at {FORM_ROWS} (uint8 and f32 b, either sign, with and "
          f"without the zero point), at offsets no head aligns and with every operand at one offset (step "
          f"and pair at 1-7, chain of {FORM_HEAD_CHAIN_K.start}-{FORM_HEAD_CHAIN_K.stop - 1} and rows at 4): "
          f"{forms_cases} cases byte-equal to their plain versions on the card, heads planned {forms_heads} "
          f"(-1: the scalar kernel), in {time.perf_counter() - t0:.1f} s")
    for name, n, elems in FOLD_SIZES:
        cpu = []
        for _ in range(n):
            x = torch.randn(elems, generator=gen, device="cuda").to(torch.bfloat16)
            cpu.append(fl.pack_tree({"w": x.cpu()}))
            del x
        on_card = [fl.PackedTree(p.buf.cuda(), p.passthrough, p.spec) for p in cpu]
        t0 = time.perf_counter()
        payloads = [_payload_bytes(p) for p in cpu]
        encode_s = time.perf_counter() - t0
        ce = fedavg.DEFAULT_CHUNK_ELEMS
        blocks = _cpu_blocks(elems, ce)
        cpu_ref = [fl.pack_tree({"w": _take_blocks(p.buf, blocks, ce)}) for p in cpu]
        launches = {}
        for weights in (list(FOLD_WEIGHTS[:n]), None):
            tag = "/".join(map(str, weights)) if weights else "None"
            t0 = time.perf_counter()
            plain = fl.packed_weighted_sum(cpu_ref, weights)
            cpu_s = time.perf_counter() - t0
            held = []
            fold.reset_launches()
            one_shot_ms = _event_ms(lambda: held.append(fl.packed_weighted_sum(on_card, weights)))
            one_shot = held.pop()
            launches["one_shot"] = dict(fold.fold_fma_.by_form)
            local = rng.randrange(n)
            order = [i for i in range(n) if i != local]
            agg = streaming.StreamingAggregator(n, weights=weights, device="cuda")

            def streamed():
                agg.add_local(local, on_card[local])
                _feed_interleaved(agg, payloads, order, rng)
                return agg.result(timeout=600)

            fold.reset_launches()
            t0 = time.perf_counter()
            got, stream_peak_mb = _peak_mb(streamed)
            stream_s = time.perf_counter() - t0
            launches["streamed"] = dict(fold.fold_fma_.by_form)
            n_cpu = plain.buf.numel()
            want = _raw(plain.buf)
            same = {"streamed": torch.equal(_raw(_take_blocks(got.buf, blocks, ce)), want),
                    "one_shot": torch.equal(_raw(_take_blocks(one_shot.buf, blocks, ce)), want),
                    "streamed_vs_one_shot": torch.equal(got.buf.view(torch.int16), one_shot.buf.view(torch.int16))}
            print(f"[fold] {name}: {n} x {elems} bf16, weights {tag}, local {local}, arrivals {order} in "
                  f"{FOLD_PIECE // 1024} KiB pieces: streamed on cuda {stream_s * 1e3:.1f} ms wall "
                  f"(stats {json.dumps({k: v for k, v in agg.stats.items() if k.startswith('agg_')})}; "
                  f"{launches['streamed']['step']} step launches for {n} contributions of "
                  f"{-(-elems // ce)} blocks, one a piece of a run, at most {streaming._RUN_ELEMS // ce} blocks; "
                  f"peak device memory {stream_peak_mb:.1f} MB above its inputs, of which its f32 accumulator "
                  f"{-(-elems // ce) * ce * 4 / 1e6:.1f} and the bf16 mean {elems * 2 / 1e6:.1f}), one-shot on "
                  f"cuda {one_shot_ms:.3f} ms cold "
                  f"({launches['one_shot']['chain']} chain launch, {sum(launches['one_shot'].values())} in all), "
                  f"CPU fold over {n_cpu} elements in {len(blocks)} blocks of {ce} ({blocks[0]}..{blocks[-1]}) "
                  f"{cpu_s * 1e3:.1f} ms; byte-equal to the CPU fold there, and streamed to one-shot "
                  f"throughout: {same}")
            if not all(same.values()) or got.buf.device.type != "cuda":
                raise AssertionError(f"fold {name} weights {tag}: the card's fold differs from the CPU fold")
            if launches["one_shot"] != {"step": 0, "pair": 0, "chain": 1, "rows": 0, "finalize": 0, "ftz": 0}:
                raise AssertionError(f"fold {name}: the one-shot fold of {n} made {launches['one_shot']} launches")
            pieces = -(-elems // max(ce, streaming._RUN_ELEMS // ce * ce))
            if not n * pieces <= launches["streamed"]["step"] <= n * -(-elems // ce) or \
                    launches["streamed"]["finalize"] != 1 or \
                    sum(launches["streamed"].values()) != launches["streamed"]["step"] + 1:
                raise AssertionError(f"fold {name}: the streamed fold made {launches['streamed']} launches")
            del plain, one_shot, got, agg
        # Device times of the pieces: one contribution's H2D (pinned), its
        # fold block by block (one launch a 2^21-element block, as before
        # the run fold) and as one run (one launch), the host's and the
        # card's share of a block's launch, the one-shot fold, the finalize,
        # and the error-feedback step over the same elements in f32.
        pinned = cpu[0].buf.pin_memory()
        h2d_ms = _event_ms(lambda: pinned.to("cuda", non_blocking=True))
        acc = torch.zeros(elems, dtype=torch.float32, device="cuda")
        w = 3.0
        src = on_card[0].buf

        def fold_one():
            for off in range(0, elems, ce):
                streaming._fold_block(acc, off, src[off:off + ce], w)

        def run_one():
            streaming._fold_block(acc, 0, src, w)

        def plain_one():  # the kernel's plain version, block by block on the card
            for off in range(0, elems, ce):
                fold.step_plain(acc[off:off + ce], w, src[off:off + ce])

        # The kernel against its plain version on the same inputs, at the
        # round's blocks (2^21 elements, the last one short) and as one
        # run, byte for byte.
        before = acc.clone()
        plain_one()
        want = acc.clone()
        for fn in (fold_one, run_one):
            acc.copy_(before)
            fn()
            if not torch.equal(acc.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"fold {name}: the kernel's bytes differ from its plain version's")
        fold_err = (acc - want).abs().max().item()
        del before, want
        fold_ms = _sync_ms(fold_one, 3, warmup=1)
        run_ms = _sync_ms(run_one, 10)
        plain_ms = _event_ms(plain_one)
        block, block_acc = src[:ce], acc[:ce]
        host_us = _host_us(lambda: fold.fold_fma_(block_acc, w, block))
        host_us_block = _host_us(lambda: streaming._fold_block(acc, 0, block, w))
        device_us = _launch_device_us(lambda: fold.fold_fma_(block_acc, w, block))
        wt = torch.full((), w, device="cuda")
        library_ms = _sync_ms(lambda: acc.addcmul_(src, wt), 10)
        # The streamed path's staging of payload bytes onto the card (a
        # pinned block, a copy into it, the H2D enqueued), host ms until the
        # card has them: one 2^21-element block alone, and a contribution
        # that arrived whole, staged and folded a piece of at most
        # streaming._RUN_ELEMS at a time as the worker does, with the most
        # device memory that took beyond the accumulator.
        stager = streaming.StreamingAggregator(1, device="cuda")
        stager._total_elems = elems
        raw = memoryview(cpu[0].buf.view(torch.uint8).numpy())
        snap = (None, raw, torch.bfloat16, 2, 0)
        nb, piece = -(-elems // ce), max(1, streaming._RUN_ELEMS // ce)

        def stage_fold():
            for a in range(0, nb, piece):
                streaming._fold_block(acc, a * ce, stager._run_elems(snap, a, min(a + piece, nb)), w)

        stage_fold()  # warm: the caching host allocator's pinned blocks
        stage_ms = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stager._run_elems(snap, 0, 1)
        torch.cuda.synchronize()
        stage_ms["block"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        _, stage_peak_mb = _peak_mb(stage_fold)
        stage_ms["contribution"] = (time.perf_counter() - t0) * 1e3
        del stager, raw, snap
        busy = _busy(fold_one) if name == "wq" else None
        one_shot_warm_ms = _sync_ms(lambda: fl.packed_weighted_sum(on_card, list(FOLD_WEIGHTS[:n])), 3, warmup=1)
        fin_ms = _event_ms(lambda: fedavg.finalize_packed_stripe(acc, 26.0, elems, "bfloat16"))
        ef = fl.ErrorFeedback()
        tree32 = {"w": acc}
        ef.compress(tree32)
        ef_ms = _event_ms(lambda: ef.compress(tree32))
        fold_bytes = elems * (2 + 4 + 4)  # read the bf16 block, read and write the f32 slice
        bound_ms = fold_bytes / hbm * 1e3
        one_shot_bytes = elems * (2 * n + 2)  # each bf16 contribution read once, the bf16 mean written
        one_shot_bound_ms = one_shot_bytes / hbm * 1e3
        block_bound_us = ce * 10 / hbm * 1e6
        times[name] = dict(ms=run_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                           library_ms=library_ms, max_abs_err=max(fold_err, forms_err), elems=elems,
                           bound_share=bound_ms / run_ms, per_block_ms=fold_ms, host_us=host_us,
                           host_us_block=host_us_block, device_us=device_us, block_bound_us=block_bound_us,
                           one_shot_ms=one_shot_warm_ms, one_shot_bound_ms=one_shot_bound_ms, one_shot_n=n,
                           phase_launches=launches, form_cases=forms_cases, stage_ms=stage_ms,
                           stage_peak_mb=stage_peak_mb, stream_peak_mb=stream_peak_mb, per_block_busy=busy)
        print(f"[fold] {name}: per contribution on the card: one run (one launch) {run_ms:.4f} ms "
              f"({fold_bytes / run_ms / 1e6:.1f} GB/s; bound {bound_ms:.4f} ms at {hbm / 1e12:.2f} TB/s, "
              f"{bound_ms / run_ms:.3f} of it); block by block ({-(-elems // ce)} launches) {fold_ms:.4f} ms "
              f"({bound_ms / fold_ms:.3f} of the bound); byte-equal to its plain version, {plain_ms:.3f} ms; "
              f"addcmul_ {library_ms:.4f} ms; a 2^21-element block's launch: host {host_us:.2f} us "
              f"(through _fold_block {host_us_block:.2f} us), card {device_us:.2f} us (bound "
              f"{block_bound_us:.2f} us); one-shot fold of {n} {one_shot_warm_ms:.4f} ms warm (bound "
              f"{one_shot_bound_ms:.4f} ms at 2n+2 = {2 * n + 2} B/elem, {one_shot_bound_ms / one_shot_warm_ms:.3f} "
              f"of it); staging payload bytes on the card through a pinned block, host: a block "
              f"{stage_ms['block']:.3f} ms, the contribution staged and folded in {-(-nb // piece)} pieces "
              f"{stage_ms['contribution']:.3f} ms, peak device memory {stage_peak_mb:.1f} MB beyond the "
              f"accumulator; the block-by-block fold under torch.profiler: {json.dumps(busy)}; "
              f"H2D of its {elems * 2 / 1e6:.2f} MB from pinned memory {h2d_ms:.3f} ms "
              f"({elems * 2 / h2d_ms / 1e6:.1f} GB/s); finalize {fin_ms:.3f} ms; error-feedback step (f32 in, "
              f"bf16 out) {ef_ms:.3f} ms; encode of the payloads {encode_s * 1e3:.1f} ms")
        del cpu, cpu_ref, on_card, payloads, pinned, acc, src, ef, tree32, block, block_acc
        torch.cuda.empty_cache()
    with _PlainFmaOff():
        times["codec"] = phase_fold_int(gen, card)
    return times


class _KeepAcc(streaming.StreamingAggregator):
    """A streaming aggregator that keeps a copy of its i32 accumulator
    (the finalize drops it) for the comparison with the CPU's."""

    def _finalize(self):
        self.kept_acc = self._acc.clone()
        return super()._finalize()


def phase_fold_int(gen, card):
    """The compressed-domain fold on the card against the CPU's: uint8 codes
    on a shared grid folded in i32 (streamed and one-shot), then the one
    rescale; and the codec's device times."""
    import random

    from rayfed_tpu_torch import tree_util
    from rayfed_tpu_torch.fl import quantize as qz

    _, (_, hbm) = _peaks(card)
    rng = random.Random(SEED + 1)
    times = {}
    for name, n, elems in FOLD_SIZES:
        ref = torch.randn(elems, generator=gen, device="cuda")
        grid = qz.make_round_grid(0.01 * torch.randn(elems, generator=gen, device="cuda"),
                                  mode="delta", expand=qz.QUANT_DELTA_EXPAND)
        spec = fl.PackSpec((("f", 0, elems, (elems,), "float32"),), tree_util.tree_flatten({"w": 0})[1],
                           grid.wire_dtype)
        codes = [torch.randint(0, 256, (elems,), dtype=torch.uint8, generator=gen, device="cuda")
                 for _ in range(n)]
        cpu = [qz.QuantizedPackedTree(c.cpu().numpy(), grid.scales, grid.zps, (), spec, grid.meta())
               for c in codes]
        on_card = [qz.QuantizedPackedTree(c, grid.scales, grid.zps, (), spec, grid.meta()) for c in codes]
        ref_cpu = ref.cpu()
        payloads = [_payload_bytes(p) for p in cpu]
        # The CPU's fold over FOLD_CPU_ELEMS of whole grid blocks spread
        # over the buffer (_cpu_blocks), on the grid of those blocks; the
        # card's accumulator is padded onto the grid, its outputs are not.
        ce = grid.chunk_elems
        blocks = _cpu_blocks(elems, ce)
        acc_blocks = lambda t: torch.cat([t[b * ce:(b + 1) * ce] for b in blocks])  # noqa: E731
        elem_blocks = lambda t: _take_blocks(t, blocks, ce)  # noqa: E731
        cpu_grid, cpu_ref, ref_cpu_ref = grid, cpu, ref_cpu
        if len(blocks) < grid.nblocks:
            n_cpu = sum(min(elems, (b + 1) * ce) - b * ce for b in blocks)
            cpu_grid = qz.QuantGrid(grid.scales[blocks], grid.zps[blocks], ce, n_cpu, grid.wire_dtype, grid.mode)
            cpu_spec = fl.PackSpec((("f", 0, n_cpu, (n_cpu,), "float32"),), spec.treedef, grid.wire_dtype)
            cpu_ref = [qz.QuantizedPackedTree(elem_blocks(torch.from_numpy(p.buf)).numpy(), cpu_grid.scales,
                                              cpu_grid.zps, (), cpu_spec, cpu_grid.meta()) for p in cpu]
            ref_cpu_ref = elem_blocks(ref_cpu)
        n_cpu = cpu_grid.total_elems
        for weights in (list(FOLD_WEIGHTS[:n]), None):
            tag = "/".join(map(str, weights)) if weights else "None"
            iw, _ = fedavg.quant_weights(weights, n)
            t0 = time.perf_counter()
            acc_cpu = fedavg._quant_reduce([p.buf for p in cpu_ref], iw, cpu_grid.nblocks, grid.chunk_elems,
                                           torch.device("cpu"))
            plain = fedavg.packed_quantized_sum(cpu_ref, weights, ref=ref_cpu_ref)
            cpu_s = time.perf_counter() - t0
            acc_card = fedavg._quant_reduce([p.buf for p in on_card], iw, grid.nblocks, grid.chunk_elems,
                                            ref.device)
            held = []
            one_shot_ms = _event_ms(lambda: held.append(fl.packed_quantized_sum(on_card, weights, ref=ref)))
            one_shot = held.pop()
            local = rng.randrange(n)
            order = [i for i in range(n) if i != local]
            agg = _KeepAcc(n, weights=weights, quant=grid, quant_ref=ref, device="cuda")

            def streamed():
                agg.add_local(local, on_card[local])
                _feed_interleaved(agg, payloads, order, rng)
                return agg.result(timeout=600)

            t0 = time.perf_counter()
            got, stream_peak_mb = _peak_mb(streamed)
            stream_s = time.perf_counter() - t0
            want, want_acc = _raw(plain.buf), _raw(acc_cpu)
            same = {"streamed": torch.equal(_raw(elem_blocks(got.buf)), want),
                    "streamed_acc": torch.equal(_raw(acc_blocks(agg.kept_acc)), want_acc),
                    "one_shot": torch.equal(_raw(elem_blocks(one_shot.buf)), want),
                    "one_shot_acc": torch.equal(_raw(acc_blocks(acc_card)), want_acc),
                    "streamed_vs_one_shot": torch.equal(_raw(got.buf), _raw(one_shot.buf)),
                    "streamed_acc_vs_one_shot": torch.equal(_raw(agg.kept_acc), _raw(acc_card))}
            print(f"[fold_int] {name}: {n} x {elems} uint8 codes on one grid ({grid.nblocks} blocks), weights "
                  f"{tag}, local {local}, arrivals {order} in {FOLD_PIECE // 1024} KiB pieces: streamed on "
                  f"cuda {stream_s * 1e3:.1f} ms wall (stats "
                  f"{json.dumps({k: v for k, v in agg.stats.items() if k.startswith('agg_')})}; peak device "
                  f"memory {stream_peak_mb:.1f} MB above its inputs, of which its i32 accumulator "
                  f"{grid.nblocks * ce * 4 / 1e6:.1f}, the kept copy of it as much and the f32 mean "
                  f"{elems * 4 / 1e6:.1f}), one-shot on "
                  f"cuda {one_shot_ms:.3f} ms (bound {elems * (n + 8) / hbm * 1e3:.3f}: the codes and ref "
                  f"read, f32 written), CPU fold over {n_cpu} elements in {len(blocks)} blocks "
                  f"({blocks[0]}..{blocks[-1]}) {cpu_s * 1e3:.1f} ms; i32 "
                  f"accumulator and finalized f32 byte-equal to the CPU's there, and streamed to one-shot "
                  f"throughout: {same}")
            if not all(same.values()) or got.buf.device.type != "cuda":
                raise AssertionError(f"integer fold {name} weights {tag}: the card's fold differs from the CPU's")
            del plain, one_shot, got, agg, acc_cpu, acc_card
        del cpu_ref, ref_cpu_ref
        # Device times of the pieces: one contribution's i32 fold over all
        # its blocks, the finalize, and the codec's quantize (an f32 update
        # against the reference, with a residual) and dequantize.
        acc = torch.zeros(grid.nblocks * grid.chunk_elems, dtype=torch.int32, device="cuda")
        src = codes[0]

        def fold_one():
            for off in range(0, elems, ce):
                fedavg.quantized_accum_kernel(acc, off, src[off:off + ce], 3)

        fold_one()
        fold_ms = _event_ms(fold_one)
        fin_ms = _event_ms(lambda: fedavg.finalize_packed_quantized(
            acc, grid.scales, grid.zps, 26.0, elems, ce, "float32", ref=ref))
        update = ref + 0.01 * torch.randn(elems, generator=gen, device="cuda")
        resid = torch.zeros(elems, device="cuda")
        quantize = lambda: qz._quantize_codes(update, ref, resid, grid)  # noqa: E731
        dequantize = lambda: qz._dequantize_codes(src, ref, grid, "float32")  # noqa: E731
        quantize(), dequantize()  # warm: the first calls load their kernels
        fold.reset_launches()
        quant_ms = _event_ms(quantize)
        quant_launches = dict(fold.fold_fma_.by_form)
        fold.reset_launches()
        deq_ms = _event_ms(dequantize)
        deq_launches = dict(fold.fold_fma_.by_form)
        times[name] = dict(quantize_ms=quant_ms, quantize_bound_ms=elems * 17 / hbm * 1e3,
                           quantize_launches=quant_launches, dequantize_ms=deq_ms,
                           dequantize_bound_ms=elems * 9 / hbm * 1e3, dequantize_launches=deq_launches)
        fold_bytes = elems * (1 + 4 + 4)  # read the codes, read and write the i32 slice
        bound_ms = fold_bytes / hbm * 1e3
        print(f"[fold_int] {name}: per contribution on the card: i32 fold {fold_ms:.3f} ms "
              f"({fold_bytes / fold_ms / 1e6:.1f} GB/s; bound {bound_ms:.3f} ms at {hbm / 1e12:.2f} TB/s, "
              f"{bound_ms / fold_ms:.3f} of it); finalize {fin_ms:.3f} ms (bound "
              f"{elems * 12 / hbm * 1e3:.3f}: i32 and ref read, f32 written); quantize {quant_ms:.3f} ms "
              f"(bound {elems * 17 / hbm * 1e3:.3f}: f32 update, ref and residual read, codes and residual "
              f"written; fold_fma {quant_launches}); dequantize {deq_ms:.3f} ms (bound {elems * 9 / hbm * 1e3:.3f}: "
              f"codes and ref read, f32 written; fold_fma {deq_launches}); the codec's plain fma off the card")
        del ref, grid, codes, cpu, on_card, ref_cpu, payloads, acc, src, update, resid
        torch.cuda.empty_cache()
    return times


# -- the federated path: two party processes on the one card ----------------

# -- the packed server optimizers: step and resync, card against CPU ---------

# The configs of the step: server momentum and FedAC, then both degenerate
# (plain FedAvg) configs.
SOPT_CONFIGS = (("momentum", (0.7, 0.9)), ("fedac", (0.8, 6.0, 0.7)),
                ("momentum", (1.0, 0.0)), ("fedac", (1.0, 3.0, 0.0)))
# 4099 elements, a ResNet-18 buffer, the Llama-3-8B rank-16 w[qv] adapters.
SOPT_SIZES = (("small", 4099), ("resnet18", 11_183_562), ("llama_adapters", 6_815_748))
SOPT_QUAD_SIZE, SOPT_QUAD_MAX = 1 << 14, 450
SOPT_FEDAC_FRAC = 0.8  # fedac_rounds_to_target_frac: FedAC in at most 0.8x plain FedAvg's rounds
SOPT_CE = 1 << 12


def _sopt_rounds_to_target(opt, dev):
    """The reference bench's 2-party heterogeneous quadratic at 2^14
    elements on ``dev``, each round's mean stepped through the card's step
    and resync (``opt`` None: plain FedAvg).  Returns (rounds, wall s)."""
    gen = torch.Generator().manual_seed(11)
    size = SOPT_QUAD_SIZE
    opt_point = torch.randn(size, generator=gen).to(dev)
    shift = (0.3 * torch.randn(size, generator=gen)).to(dev)
    curv = torch.linspace(0.02, 0.12, size, device=dev)
    target = 1e-3 * float((opt_point ** 2).mean())
    tmpl = fl.pack_tree({"w": torch.zeros(size)}, torch.float32)
    runner = None if opt is None else fl.PackedServerOptimizer(opt, device=dev)
    x = torch.zeros(size, device=dev)
    t0 = time.perf_counter()
    for r in range(SOPT_QUAD_MAX):
        ups = [x - curv * (x - (opt_point + s)) for s in (shift, -shift)]
        avg = (ups[0] + ups[1]) * 0.5
        if runner is not None:
            runner.ensure(x)
            new_x = runner.step_fn(x)(fl.PackedTree(avg, tmpl.passthrough, tmpl.spec)).buf
            runner.resync(x, new_x)
            x = new_x
        else:
            x = avg
        if float(((x - opt_point) ** 2).mean()) <= target:
            return r + 1, time.perf_counter() - t0
    return SOPT_QUAD_MAX, time.perf_counter() - t0


def _sopt_topologies(dev):
    """The reference bench's topology byte-identity on ``dev``: from one
    replicated state, the post-step quantized downlink of the streaming
    fold, of a quorum cutoff round (whose subset refold feeds the step at
    the subset's Σw) and of the hierarchy's regrouped presummed fold, each
    decoded from its serialized wire bytes.  Returns each path's (the
    coordinator's decode, the receiver's decode) as host bytes."""
    from rayfed_tpu_torch.fl import quantize as qz
    from rayfed_tpu_torch.fl.hierarchy import RegionSumTree, partial_sum_dtype
    from rayfed_tpu_torch.transport import wire

    gen = torch.Generator().manual_seed(SEED + 11)
    n = 40_000
    ref = torch.randn(n, generator=gen)
    packeds = [fl.pack_tree({"w": ref + 0.01 * torch.randn(n, generator=gen)}, torch.float32) for _ in range(4)]
    grid = qz.make_round_grid((0.01 * torch.randn(n, generator=gen)).numpy(), chunk_elems=SOPT_CE,
                              mode="delta", expand=4.0)
    ws = [3, 1, 2, 1]
    qts = [qz.quantize_packed(p, grid, ref=ref) for p in packeds]
    ref_d = ref.to(dev)

    def step_and_downlink(result):
        runner = fl.PackedServerOptimizer(fl.fedac(1.0, 3.0, 0.5), device=dev)
        runner.ensure(ref_d)
        wire_result, decoded, _ = qz.quantize_downlink(runner.step_fn(ref_d)(result), grid, ref_d, None)
        got = wire.decode_payload(_payload_bytes(wire_result), allowed={})
        receiver = got.dequantize(torch.float32, ref=ref_d)
        return _raw(decoded.buf), _raw(receiver.buf)

    def agg(k, **kw):
        return streaming.StreamingAggregator(k, chunk_elems=SOPT_CE, quant=grid, quant_ref=ref_d, device=dev, **kw)

    flat = agg(4, weights=ws)
    for i, q in enumerate(qts):
        flat.add_local(i, q)
    out = {"streaming": step_and_downlink(flat.result(timeout=120))}
    ps_dt = partial_sum_dtype(grid.qabs_max, sum(ws))
    root = agg(2, weights=[float(ws[0] + ws[1]), float(ws[2] + ws[3])], presummed=ps_dt)
    for g, members in enumerate(((0, 1), (2, 3))):
        acc = sum(ws[i] * torch.as_tensor(qts[i].buf).to(torch.int64) for i in members)
        spec = fl.PackSpec(qts[0].spec.entries, qts[0].spec.treedef, ps_dt)
        root.add_local(g, RegionSumTree(acc.numpy().astype(ps_dt), grid.scales, grid.zps, (), spec, grid.meta()))
    out["hierarchy"] = step_and_downlink(root.result(timeout=120))
    cut = agg(4, weights=ws, quorum=3, labels=["a", "b", "c", "d"])
    cut.sink(1)  # never arrives
    for i in (0, 2, 3):
        cut.add_local(i, qts[i])
    out["quorum_cutoff"] = step_and_downlink(cut.result(timeout=120, deadline_s=0.4))
    out["quorum_subset"] = step_and_downlink(
        fedavg.packed_quantized_sum([qts[0], qts[2], qts[3]], [ws[0], ws[2], ws[3]], ref=ref_d))
    return out


def phase_server_opt(card):
    """The packed server optimizers on the card (one process, after the
    reference bench's server-opt section): the step and the resync at three
    sizes and four configs byte-equal to the CPU plain version, their device
    ms and fold_fma launches per call; FedAC's rounds to target on the
    quadratic through the card's step and resync; the post-step quantized
    downlink byte-equal across the streaming fold, a quorum cutoff round and
    the hierarchy's regrouped fold, on the card and the CPU alike."""
    _, (_, hbm) = _peaks(card)
    gen = torch.Generator().manual_seed(SEED + 10)
    out = {"step": {}}
    for size_name, n in SOPT_SIZES:
        x = torch.randn(n, generator=gen)
        avg = x - 0.01 * torch.randn(n, generator=gen)
        st = torch.randn(n, generator=gen)
        xc, avgc, stc = x.cuda(), avg.cuda(), st.cuda()
        for kind, hyper in SOPT_CONFIGS:
            step = fedavg.server_step_kernel(kind, hyper)
            resync = fedavg.server_resync_kernel(kind, hyper)
            want = step(x, avg, st)
            want_r = resync(x, want, st)[0]
            fold.fold_fma_.launches = 0
            got = step(xc, avgc, stc)
            step_launches = fold.fold_fma_.launches
            fold.fold_fma_.launches = 0
            got_r = resync(xc, got, stc)[0]
            resync_launches = fold.fold_fma_.launches
            same = (torch.equal(_raw(got), _raw(want)), torch.equal(_raw(got_r), _raw(want_r)))
            if not all(same) or got.device.type != "cuda" or got_r.device.type != "cuda":
                raise AssertionError(f"[server_opt] {size_name} {kind}{hyper}: the card's step/resync differ from "
                                     f"the CPU's: {same}")
            step_ms = _sync_ms(lambda: step(xc, avgc, stc), 10)
            resync_ms = _sync_ms(lambda: resync(xc, got, stc), 10)
            degenerate = step_launches == 0
            # The step reads x, avg and the state and writes x' (16 B per
            # element); the resync reads x, x' (and z) and writes the state.
            step_bytes = 0 if degenerate else 16 * n
            resync_bytes = (12 if kind == "momentum" else 16) * n
            rec = dict(ms=step_ms, resync_ms=resync_ms, launches=step_launches, resync_launches=resync_launches,
                       bound_ms=step_bytes / hbm * 1e3, resync_bound_ms=resync_bytes / hbm * 1e3, elems=n)
            if size_name == "llama_adapters" and (kind, hyper) == SOPT_CONFIGS[1]:
                # The plain version of the same step on the card (ops/fold.py fma_ftz).
                lam, gamma, beta = hyper

                def plain():
                    d = ftz.sub(xc, avgc)
                    y = fold.fma_ftz(fedavg.f32_scalar(-lam, xc.device), d, xc)
                    z = fold.fma_ftz(fedavg.f32_scalar(-gamma, xc.device), d, stc)
                    return fold.fma_ftz(fedavg.f32_scalar(1.0 - beta, xc.device), y, ftz.mul(beta, z))

                if not torch.equal(_raw(plain()), _raw(got)):
                    raise AssertionError("[server_opt] the card's FedAC step differs from its plain version")
                rec["plain_ms"] = _sync_ms(plain, 5)
            out["step"][(size_name, kind, hyper)] = rec
            print(f"[server_opt] {size_name} ({n} f32) {kind}{hyper}: step {step_ms:.4f} ms on the card "
                  f"({step_launches} fold_fma launches; bound {rec['bound_ms']:.3g} ms at 16 B/elem"
                  + (", the aggregate itself" if degenerate else f", {rec['bound_ms'] / step_ms:.3f} of it")
                  + f"), resync {resync_ms:.4f} ms ({resync_launches} launches; bound {rec['resync_bound_ms']:.3g} "
                  f"ms); byte-equal to the CPU plain version: step and resync")
        del x, avg, st, xc, avgc, stc
        torch.cuda.empty_cache()
    plain_rounds, plain_s = _sopt_rounds_to_target(None, torch.device("cuda"))
    fedac_rounds, fedac_s = _sopt_rounds_to_target(fl.fedac(1.0, 6.0, 0.7), torch.device("cuda"))
    frac = fedac_rounds / plain_rounds
    print(f"[server_opt] rounds to target (quadratic, 2 parties, 2^14 elements, the card's step and resync): "
          f"plain FedAvg {plain_rounds} rounds in {plain_s:.3f} s, fedac(1.0, 6.0, 0.7) {fedac_rounds} rounds in "
          f"{fedac_s:.3f} s; fedac_rounds_to_target_frac {frac:.4f} (gate <= {SOPT_FEDAC_FRAC})")
    if plain_rounds >= SOPT_QUAD_MAX or frac > SOPT_FEDAC_FRAC:
        raise AssertionError(f"[server_opt] rounds to target: plain {plain_rounds}, fedac {fedac_rounds}")
    card_paths, cpu_paths = _sopt_topologies(torch.device("cuda")), _sopt_topologies(torch.device("cpu"))
    ref_coord, ref_recv = card_paths["streaming"]
    bitexact = all(torch.equal(c, ref_coord) and torch.equal(r, ref_recv) for c, r in
                   (card_paths["streaming"], card_paths["hierarchy"])) and all(
        torch.equal(c, r) for c, r in card_paths.values()) and all(
        torch.equal(card_paths[k][0], card_paths["quorum_subset"][0]) for k in ("quorum_cutoff",)) and all(
        torch.equal(card_paths[k][i], cpu_paths[k][i]) for k in card_paths for i in (0, 1))
    print(f"[server_opt] post-step quantized downlink, decoded from its wire bytes: streaming fold = hierarchy "
          f"regrouped fold, quorum cutoff = its subset refold, coordinator = receiver, card = CPU: "
          f"server_opt_agg_bitexact {bitexact}")
    if not bitexact:
        raise AssertionError("[server_opt] server_opt_agg_bitexact failed")
    out.update(plain_rounds=plain_rounds, fedac_rounds=fedac_rounds, rounds_frac=frac, plain_s=plain_s,
               fedac_s=fedac_s, bitexact=bitexact)
    return out


FED_PARTIES = ("alice", "bob")
FED_LINKS = ("off", "auto")  # TCP, then whatever the local link "auto" decides
FED_TIMEOUT_S = 540  # hard limit on the party processes, all three sessions together
ROUNDS = 2  # FedAvg rounds of the round session (local link "auto")
OVERLAP_ROUNDS = 3  # pipelined rounds in coordinator mode
OVERLAP_PARTS = ("round_overlap", "round_overlap_ring", "round_overlap_quant")
FED_INIT = dict(
    cross_silo_messages_max_size_in_bytes=4 << 30,  # wq is 1.07 GB; default cap 500 MiB
    cross_silo_retry_policy={"maxAttempts": 30, "initialBackoff": "0.2s", "maxBackoff": "1s"},
    enable_waiting_for_other_parties_ready=True,
)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _leaf_digest(value):
    """SHA-256 over the bytes of every leaf in flatten order, with each
    tensor's dtype, shape and device type beside it."""
    from rayfed_tpu_torch import tree_util

    h, meta, nbytes = hashlib.sha256(), [], 0
    for leaf in tree_util.tree_leaves(value):
        if isinstance(leaf, torch.Tensor):
            raw = leaf.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()
            h.update(raw)
            nbytes += raw.nbytes
            meta.append([str(leaf.dtype), list(leaf.shape), leaf.device.type])
        else:
            h.update(repr(leaf).encode())
    return {"sha256": h.hexdigest(), "meta": meta, "nbytes": nbytes}


class _ModelCache:
    """Keeps alice's model across the fed sessions of her process (one per
    link mode), so the base is built once.  Not a container: fed passes
    it to the actor as it is, where a dict would arrive rebuilt."""

    m = None


class _Trainer:
    """alice's actor: the Llama base, rank-16 adapters on w[qv] and Adam
    state, random from SEED."""

    def __init__(self, cache, cfg_name, cfg_kw, train_len, device):
        self.device = device
        if cache.m is None:
            cfg = getattr(llama, cfg_name)(**cfg_kw)
            gen = torch.Generator(device=device).manual_seed(SEED)
            params = llama.init_llama(cfg, gen, device=device)
            adapters = lora.init_lora(params, lora.LoraConfig(rank=LORA_RANK, targets=(r"w[qv]$",)),
                                      gen, device=device)
            cache.m = dict(
                params=params, adapters=adapters, opt=llama.init_adam(adapters),
                ids=torch.randint(0, cfg.vocab_size, (1, train_len), generator=gen, device=device),
                step=llama.make_lora_train_step(cfg, lr=TRAIN_LR, attn_fn=flash_attention),
            )
        self.m = cache.m

    def step(self):
        """One LoRA step through the three kernels; returns the adapters
        (tensors on this party's card) and the step's launch counts."""
        m = self.m
        _zero_counts()
        _sync(self.device)
        t0 = time.perf_counter()
        m["adapters"], m["opt"], loss = m["step"](m["adapters"], m["opt"], m["params"], m["ids"])
        _sync(self.device)
        step_ms = (time.perf_counter() - t0) * 1e3
        return {"adapters": m["adapters"], "loss": loss.item(), "step_ms": step_ms, "launches": _counts()}

    def base_wq(self):
        return self.m["params"]["layers"]["wq"]


class _RoundTrainer:
    """A party's trainer in the FedAvg round: the Llama base (alice's
    from her cache, bob's built here; both from SEED, so equal), its own
    Adam state and token ids, one LoRA step per round."""

    def __init__(self, cache, cfg_name, cfg_kw, train_len, device, index):
        self.device = device
        if cache.m is None:
            _Trainer(cache, cfg_name, cfg_kw, train_len, device)
        self.params, self.step_fn = cache.m["params"], cache.m["step"]
        gen = torch.Generator(device=device).manual_seed(SEED + 1 + index)
        vocab = self.params["embed"].shape[0]
        self.ids = torch.randint(0, vocab, (1, train_len), generator=gen, device=device)
        self.opt, self.steps = None, []
        self.sent = None  # a list while recording the packed train outputs
        self.play = None  # recorded outputs handed back, in order, instead of a step

    def record(self, on):
        self.sent = [] if on else None

    def replay(self, on):
        """Return the recorded outputs, one per round, instead of stepping
        (on), or step again (off)."""
        self.play, self.sent = (self.sent, None) if on else (None, self.sent)

    def initial(self):
        """The round's starting adapters, from the seed."""
        gen = torch.Generator(device=self.device).manual_seed(SEED + 100)
        return lora.init_lora(self.params, lora.LoraConfig(rank=LORA_RANK, targets=(r"w[qv]$",)),
                              gen, device=self.device)

    def train(self, wire_adapters):
        if self.play is not None:
            return self.play.pop(0)
        adapters = fl.decompress(wire_adapters)
        if self.opt is None:
            self.opt = llama.init_adam(adapters)
        _zero_counts()
        _sync(self.device)
        t0 = time.perf_counter()
        adapters, self.opt, loss = self.step_fn(adapters, self.opt, self.params, self.ids)
        _sync(self.device)
        self.steps.append({"step_ms": (time.perf_counter() - t0) * 1e3, "loss": loss.item(),
                           "launches": _counts()})
        out = fl.compress(adapters, packed=True)
        if self.sent is not None:
            self.sent.append(out)
        return out

    def contributions(self):
        """The recorded train outputs, one per round, and stop recording."""
        sent, self.sent = self.sent, None
        return sent

    def report(self):
        peak = torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0
        steps, self.steps = self.steps, []
        return {"steps": steps, "max_memory_allocated": peak}


def _dga_replay(sent):
    """The pipelined rounds' recurrence replayed from the recorded train
    outputs ``sent[party][r]``: round 0 folds the raw outputs, round r the
    DGA-corrected ones ``agg + (u_r − c_{r−1})``; the fold is the one-shot
    packed mean (weights 1: the streamed fold's bytes).  On the card the
    outputs came to."""
    from rayfed_tpu_torch.fl.overlap import dga_correct

    contribs, agg = None, None
    for r in range(len(sent[FED_PARTIES[0]])):
        u = {p: sent[p][r] for p in FED_PARTIES}
        contribs = u if agg is None else {p: dga_correct(agg, u[p], contribs[p]) for p in FED_PARTIES}
        agg = fedavg.packed_weighted_sum([contribs[p] for p in FED_PARTIES])
    return fl.decompress(agg)


# The round session's parts in order, each from the last one's result:
# (key, run_fedavg_rounds options, rounds).  The first wire_quant round has
# no grid yet and ships bf16, as in the JAX package.
ROUND_PARTS = (
    ("round", {"streaming_agg": True}, ROUNDS),
    ("round_quant", {"streaming_agg": True, "wire_quant": "uint8"}, ROUNDS),
    # Two parties: two stripes, each folded by its owner (streaming_agg is
    # the hub's, off).
    ("round_ring", {"mode": "ring"}, ROUNDS),
    # The pipelined rounds: round k's aggregation under round k+1's step.
    ("round_overlap", {"overlap": True}, OVERLAP_ROUNDS),
    ("round_overlap_ring", {"overlap": True, "mode": "ring"}, ROUNDS),
    ("round_overlap_quant", {"overlap": True, "streaming_agg": True, "wire_quant": "uint8"}, ROUNDS),
    # The packed server optimizers: FedAC over the compressed-domain hub
    # (stepped at alice before the downlink), server momentum under the
    # pipelined rounds (the one-round-stale mean displacement).
    ("round_server_opt", {"streaming_agg": True, "wire_quant": "uint8", "server_opt": fl.fedac(1.0, 3.0, 0.5)},
     ROUNDS),
    ("round_overlap_server_opt", {"overlap": True, "server_opt": fl.server_momentum(1.0, 0.9)}, ROUNDS),
)
SOPT_PARTS = ("round_server_opt", "round_overlap_server_opt")


class _StateDigests:
    """Records the SHA-256 of this process's server-opt state after every
    resync (the replicated state the parties must agree on), for the parts
    run inside it."""

    def __enter__(self):
        from rayfed_tpu_torch.fl import server_opt

        self.seen, cls = [], server_opt.PackedServerOptimizer
        self.cls, self.resync = cls, cls.resync

        def recording(opt, x_buf, new_buf):
            self.resync(opt, x_buf, new_buf)
            self.seen.append(_leaf_digest(list(opt.state.bufs)))

        cls.resync = recording
        return self

    def __exit__(self, *exc):
        self.cls.resync = self.resync


def _round_session(fed, party, cache, cfg_name, cfg_kw, train_len, device, ckpt_root):
    """The packed FedAvg rounds: both parties train, alice folds on her
    card; then the ring and the pipelined rounds."""
    from rayfed_tpu_torch.fl.ring import RING_STATS
    from rayfed_tpu_torch.runtime import get_runtime

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    trainers = {p: fed.remote(_RoundTrainer).party(p).remote(cache, cfg_name, cfg_kw, train_len, device, i)
                for i, p in enumerate(FED_PARTIES)}
    adapters = fed.get(trainers["alice"].initial.remote())
    tm = get_runtime().transport
    digest = fed.remote(_leaf_digest)
    out = {}
    for key, kw, rounds in ROUND_PARTS:
        replay = key == "round_overlap"  # its result is replayed from the recorded outputs
        if replay:
            fed.get([trainers[p].record.remote(True) for p in FED_PARTIES])
        timings = []
        logged = tm.transfer_log.total_recorded
        in0 = tm.get_stats()["receive_bytes"]
        fold.reset_launches()
        ring0 = dict(RING_STATS)
        t0 = time.perf_counter()
        with _StateDigests() as states:
            adapters = fl.run_fedavg_rounds(trainers, adapters, rounds=rounds, compress_wire=True,
                                            packed_wire=True, timings=timings, **kw)
            _sync(device)
        wall_s = time.perf_counter() - t0
        fold_launches = fold.fold_fma_.launches  # this party's float folds and codec FMAs of the session
        fold_by_form = dict(fold.fold_fma_.by_form)
        sent, _ = tm.transfer_log.records_since(logged)
        digests = fed.get([digest.party(p).remote(adapters) for p in FED_PARTIES])
        trainer_reports = fed.get([trainers[p].report.remote() for p in FED_PARTIES])
        stats = tm.get_stats()
        out[key] = {
            "rounds": rounds,
            "replay": (_leaf_digest(_dga_replay(dict(zip(FED_PARTIES, fed.get(
                [trainers[p].contributions.remote() for p in FED_PARTIES])))))
                       if replay else None),
            "wall_s": wall_s,
            "state_digests": states.seen,
            "fold_launches": fold_launches,
            "fold_by_form": fold_by_form,
            "ring_stats": {k: RING_STATS[k] - ring0[k] for k in RING_STATS},
            "timings": timings,
            "pushed": [r.nbytes for r in sent if r.direction == "send"],
            "digests": dict(zip(FED_PARTIES, digests)),
            "trainers": dict(zip(FED_PARTIES, trainer_reports)),
            "ingress": stats["receive_bytes"] - in0,
            "delta": {k: stats[k] for k in ("delta_stream_frames", "delta_full_frames",
                                            "delta_logical_bytes", "delta_wire_bytes")},
        }
    out.update(_secagg_round_parts(fed, party, trainers, adapters, device))
    out.update(_ckpt_round_parts(fed, party, cache, cfg_name, cfg_kw, train_len, device, adapters, ckpt_root))
    return out


# Secure aggregation on the Llama round (phase_secagg (c)): from one start,
# compressed-domain rounds plain and masked, both stepping (their walls
# compared), then the masked run's recorded train outputs replayed through
# plain rounds (the masked aggregate's bytes compared).
SECAGG_ROUNDS = 3
SECAGG_ROUND_PARTS = (("round_secagg_plain", False, False), ("round_secagg", True, False),
                      ("round_secagg_replay", False, True))


def _secagg_round_parts(fed, party, trainers, adapters, device):
    """The secure-aggregation parts of the round session: each run's round
    walls, timings, final digests and masked-round count, and alice's
    unhidden keystream time at the adapters' size (``mask_gen_ms``)."""
    from rayfed_tpu_torch.fl import quantize as qz
    from rayfed_tpu_torch.fl import secagg as sa
    from rayfed_tpu_torch.runtime import get_runtime

    digest = fed.remote(_leaf_digest)
    out = {}
    for key, secure, replay in SECAGG_ROUND_PARTS:
        qz.reset_compressors()
        if replay:
            fed.get([trainers[p].replay.remote(True) for p in FED_PARTIES])
        elif secure:
            fed.get([trainers[p].record.remote(True) for p in FED_PARTIES])
        masked0, marks, timings = sa.SECAGG_STATS["masked_rounds"], [time.perf_counter()], []
        final = fl.run_fedavg_rounds(trainers, adapters, rounds=SECAGG_ROUNDS, compress_wire=True,
                                     packed_wire=True, streaming_agg=True, wire_quant="uint8",
                                     secure_agg=secure, timings=timings,
                                     on_round=lambda r, _p: marks.append(time.perf_counter()))
        _sync(device)
        if replay:
            fed.get([trainers[p].replay.remote(False) for p in FED_PARTIES])
        out[key] = {
            "round_s": [b - a for a, b in zip(marks, marks[1:])], "timings": timings,
            "masked_rounds": sa.SECAGG_STATS["masked_rounds"] - masked0,
            "digests": dict(zip(FED_PARTIES, fed.get([digest.party(p).remote(final) for p in FED_PARTIES]))),
            "trainers": dict(zip(FED_PARTIES, fed.get([trainers[p].report.remote() for p in FED_PARTIES]))),
        }
    tm = get_runtime().transport
    n = fl.pack_tree(adapters, torch.float32).buf.numel()
    masker = sa.RoundMasker(tm.secagg_keys, party, [p for p in FED_PARTIES if p != party],
                            session="probe", stream="probe", round_index=0)
    t0 = time.perf_counter()
    masker.net_mask(n)
    out["round_secagg"]["mask_gen_ms"] = (time.perf_counter() - t0) * 1e3
    out["round_secagg"]["elements"] = n
    out["round_secagg"]["suite"] = [tm.secagg_keys.kex_scheme, tm.secagg_keys.prg_scheme]
    out["round_secagg"]["stats"] = dict(sa.SECAGG_STATS)
    return out


def _fed_session(fed, party, cache, cfg_name, cfg_kw, train_len, device):
    """One exchange: alice steps and both results cross to bob; each party
    fingerprints what it holds and both require the fingerprints equal."""
    from rayfed_tpu_torch.runtime import get_runtime

    trainer = fed.remote(_Trainer).party("alice").remote(cache, cfg_name, cfg_kw, train_len, device)
    objs = {"step": trainer.step.remote(), "wq": trainer.base_wq.remote()}
    digest = fed.remote(_leaf_digest)
    digests, get_s = {}, {}
    for name, obj in objs.items():
        # One transfer at a time: bob's fingerprint task takes the push,
        # and both parties wait for its result before the next one moves.
        t0 = time.perf_counter()
        digests[("bob", name)] = fed.get(digest.party("bob").remote(obj))
        get_s[name] = time.perf_counter() - t0
    got = {n: fed.get(o) for n, o in objs.items()}  # bob's came with the pushes
    for name, obj in objs.items():
        digests[("alice", name)] = fed.get(digest.party("alice").remote(obj))
    for name in objs:
        a, b = digests[("alice", name)], digests[("bob", name)]
        if a != b:
            raise AssertionError(f"{name}: alice holds {a['sha256']} {a['meta'][:2]}, bob {b['sha256']} {b['meta'][:2]}")
        if not a["meta"] or any(m[2] != device.type for m in a["meta"]):
            raise AssertionError(f"{name}: leaves not on {device.type}: {a['meta']}")
    from rayfed_tpu_torch import tree_util

    held = tree_util.tree_leaves(got["step"]["adapters"]) + [got["wq"]]
    if not all(isinstance(t, torch.Tensor) and t.device.type == device.type for t in held):
        raise AssertionError(f"{party} holds leaves off {device.type}")
    tm = get_runtime().transport
    peer = next(p for p in FED_PARTIES if p != party)
    tm.ping(peer, timeout_s=10)
    ids = {o.get_fed_task_id(): n for n, o in objs.items()}
    transfers = [dict(r._asdict(), name=ids[r.up_id]) for r in tm.transfer_log.records() if r.up_id in ids]
    return got, {
        "link": tm.effective_transport_options(peer)["local_link"],
        "transfers": transfers,
        "breakdown_ms": tm.get_stats()["send_path_breakdown_ms"],
        "get_s": get_s,
        "digests": {n: digests[("alice", n)] for n in objs},
        "train": {k: v for k, v in got["step"].items() if k != "adapters"},
    }


def _fed_party(party, ports, cfg_name, cfg_kw, train_len, device, ckpt_root, out):
    """A party process of the federated phase; both parties run this same
    driver, one fed session per link mode.  Puts its report on ``out``."""
    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch.transport import wire

    report = {"party": party, "links": {}}
    try:
        cache = _ModelCache()
        for link in FED_LINKS:
            cluster = {p: {"address": f"127.0.0.1:{port}", "transport_options": {"local_link": link}}
                       for p, port in zip(FED_PARTIES, ports[link])}
            runtime = fed.init(address="local", cluster=cluster, party=party, device=device, **FED_INIT)
            dev = runtime.transport.device
            got, report["links"][link] = _fed_session(fed, party, cache, cfg_name, cfg_kw, train_len, dev)
            fed.shutdown()
        if party == "bob":  # the codec's copies alone, on the received wq
            wq = got["wq"]
            d2h_s = []
            for _ in range(2):  # the second reuses the cached pinned block
                _sync(dev)
                t0 = time.perf_counter()
                bufs = wire.encode_payload(wq)  # card -> pinned host buffer
                d2h_s.append(time.perf_counter() - t0)
                payload = bytearray(b"".join(bytes(b) for b in bufs))
                del bufs
            t0 = time.perf_counter()
            back = wire.decode_payload(payload, device_put=True, device=dev)  # host -> card
            _sync(dev)
            h2d_s = time.perf_counter() - t0
            if not torch.equal(back, wq):
                raise AssertionError("wq changed through encode and decode")
            report["copies"] = {"nbytes": wq.numel() * wq.element_size(), "d2h_s": d2h_s, "h2d_s": h2d_s}
            del wq, back, payload
        del got  # bob's received wq leaves the card before the round
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        cluster = {p: {"address": f"127.0.0.1:{port}", "transport_options": {"local_link": "auto"}}
                   for p, port in zip(FED_PARTIES, ports["round"])}
        fed.init(address="local", cluster=cluster, party=party, device=device, **FED_INIT)
        with _PlainFmaOff():  # every round's codec and fold on the kernel, none on its plain version
            report.update(_round_session(fed, party, cache, cfg_name, cfg_kw, train_len, dev, ckpt_root))
        fed.shutdown()
        out.put(report)
    except BaseException:
        out.put({"party": party, "error": traceback.format_exc()})
        raise


def _run_parties(cfg_name, cfg_kw, train_len, device, ckpt_root=None):
    """The federated phase's parties: one fed session per link mode, then
    the round session (its checkpointed runs write under ``ckpt_root``, a
    temporary directory when None)."""
    ports = {link: _free_ports(len(FED_PARTIES)) for link in (*FED_LINKS, "round")}
    ckpt_root = ckpt_root or tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    return _spawn_parties(_fed_party, (ports, cfg_name, cfg_kw, train_len, device, ckpt_root), FED_TIMEOUT_S)


def _spawn_parties(target, args, timeout_s, parties=FED_PARTIES, exit_codes=None):
    """Spawn ``target(party, *args, out)`` for every party; each must put its
    final report on ``out`` and exit with ``exit_codes.get(party, 0)`` within
    ``timeout_s``, or the phase fails (a hung party is killed).  A message
    with ``"progress": True`` is not final: it is kept in order under the
    party's ``"progress"`` key."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = {p: ctx.Process(target=target, name=f"party-{p}", args=(p, *args, out))
             for p in parties}
    for proc in procs.values():
        proc.start()
    reports, progress = {}, {p: [] for p in parties}
    deadline = time.monotonic() + timeout_s
    try:
        while len(reports) < len(procs):  # drain the queue before joining
            if time.monotonic() > deadline:
                raise TimeoutError(f"parties gave no report in {timeout_s} s: "
                                   f"{sorted(set(procs) - set(reports))}")
            try:
                r = out.get(timeout=2)
            except queue.Empty:
                gone = [p for p, proc in procs.items() if p not in reports and not proc.is_alive()]
                if gone:
                    raise RuntimeError(f"party {gone} exited {[procs[p].exitcode for p in gone]} "
                                       f"without a report")
                continue
            if r.get("progress"):
                progress[r["party"]].append(r)
                continue
            reports[r["party"]] = r
            if "error" in r:
                break  # its peer may wait on it forever: fail now
        failed = any("error" in r for r in reports.values())
        for proc in procs.values():
            proc.join(0 if failed else max(0.0, deadline - time.monotonic()))
    finally:
        for proc in procs.values():
            if proc.is_alive():
                proc.kill()
                proc.join(10)
    errors = {p: r["error"] for p, r in reports.items() if "error" in r}
    if errors:
        raise AssertionError("party failed:\n" + "\n".join(f"[{p}] {e}" for p, e in errors.items()))
    codes = {p: proc.exitcode for p, proc in procs.items()}
    want = {p: (exit_codes or {}).get(p, 0) for p in procs}
    if codes != want:
        raise AssertionError(f"party exit codes {codes}, want {want}")
    for p, r in reports.items():
        if progress[p]:
            r["progress"] = progress[p]
    return reports


def phase_federated(ckpt_root):
    """The federated path: alice's actor trains and bob receives the
    adapters and the stacked wq on his card, over TCP and the local link."""
    cfg = llama.llama3_8b(param_dtype=torch.bfloat16, remat=True)
    torch.cuda.empty_cache()  # the parties' card state is their own
    t0 = time.perf_counter()
    reports = _run_parties("llama3_8b", dict(param_dtype=torch.bfloat16, remat=True), TRAIN_LEN, None, ckpt_root)
    wall = time.perf_counter() - t0
    want = _lora_step_want(cfg.num_layers, cfg.remat)
    return _federated_summary(reports, want, wall)


def _federated_summary(reports, want, wall):
    """Check the parties' reports against each other and print them."""
    alice, bob = reports["alice"], reports["bob"]
    out = {"wall_s": wall, "links": {}, "launches": {}}
    for link in FED_LINKS:
        a, b = alice["links"][link], bob["links"][link]
        train = a["train"]
        if train["launches"] != want:
            raise AssertionError(f"link {link}: expected launches {want} in alice's step, got {train['launches']}")
        if a["digests"] != b["digests"]:
            raise AssertionError(f"link {link}: the parties' fingerprints differ")
        decided = {p: r["links"][link]["link"] for p, r in reports.items()}
        print(f"[fed] link {link}: decided {decided['alice']} (alice->bob), {decided['bob']} (bob->alice)")
        if not (decided["alice"] or {}).get("decided"):
            raise AssertionError(f"link {link}: alice's link to bob was never decided: {decided}")
        print(f"[fed] link {link}: alice's LoRA step {train['step_ms']:.1f} ms, loss {train['loss']:.6f}, "
              f"launches {train['launches']}; bob's wait for each result (step included) "
              f"{ {n: round(t, 3) for n, t in b['get_s'].items()} } s")
        for rec in sorted(a["transfers"], key=lambda r: r["nbytes"]):
            if rec["direction"] != "send":
                continue
            recv = next(r for r in b["transfers"] if r["name"] == rec["name"] and r["direction"] == "recv")
            d = a["digests"][rec["name"]]
            print(f"[fed] link {link}: {rec['name']} {rec['nbytes'] / 1e6:.2f} MB payload "
                  f"({d['nbytes'] / 1e6:.2f} MB in {len(d['meta'])} tensors, sha256 {d['sha256'][:16]}): "
                  f"alice's send {rec['seconds'] * 1e3:.1f} ms ({rec['nbytes'] / rec['seconds'] / 1e9:.3f} GB/s), "
                  f"bob's socket read {recv['seconds'] * 1e3:.1f} ms")
        print(f"[fed] link {link}: alice's send path {a['breakdown_ms']}")
        out["links"][link] = {"decided": decided, "train": train, "alice": a, "bob": b}
        out["launches"] = train["launches"]
    c = bob["copies"]
    d2h = ", ".join(f"{t * 1e3:.1f} ms ({c['nbytes'] / t / 1e9:.2f} GB/s)" for t in c["d2h_s"])
    print(f"[fed] bob's codec copies of wq ({c['nbytes'] / 1e9:.3f} GB): D2H through a pinned buffer "
          f"{d2h} (first, then with the pinned block cached), H2D from the payload "
          f"{c['h2d_s'] * 1e3:.1f} ms ({c['nbytes'] / c['h2d_s'] / 1e9:.2f} GB/s)")
    print(f"[fed] both links and the round in {wall:.1f} s, party processes included")
    out["copies"] = c
    out["round"] = _round_summary(alice["round"], bob["round"], want)
    out["round_quant"] = _round_summary(alice["round_quant"], bob["round_quant"], want, quant=True)
    out["round_ring"] = _ring_round_summary(alice["round_ring"], bob["round_ring"], want)
    for key in OVERLAP_PARTS:
        out[key] = _overlap_summary(alice[key], bob[key], want, key)
    out["round_server_opt"] = _server_opt_round_summary(alice, bob, want, "round_server_opt", "round_quant")
    out["round_overlap_server_opt"] = _server_opt_round_summary(alice, bob, want, "round_overlap_server_opt",
                                                                "round_overlap")
    out["round_secagg"] = _secagg_round_summary(alice, bob, want)
    out["checkpoint"] = {tag: {"alice": alice[tag], "bob": bob[tag]} for tag in CKPT_RUNS}
    sync = {k: alice[k]["wall_s"] / alice[k]["rounds"] for k in ("round", "round_quant", "round_ring")}
    pipelined = {k: alice[k]["wall_s"] / alice[k]["rounds"]
                 for k in ("round_overlap", "round_overlap_quant", "round_overlap_ring")}
    print(f"[round_overlap] alice's wall per round: synchronous {json.dumps(sync)} s, "
          f"pipelined {json.dumps(pipelined)} s")
    out["round_overlap"]["per_round_s"] = {"sync": sync, "pipelined": pipelined}
    # The fold kernel's launches by form (step, pair, chain, rows), each
    # party's, in each round part.
    out["fold_by_form"] = {key: {p: reports[p][key]["fold_by_form"] for p in FED_PARTIES}
                           for key, _, _ in ROUND_PARTS}
    print(f"[round] fold_fma launches by form: {json.dumps(out['fold_by_form'])}")
    return out


def _secagg_round_summary(alice, bob, want):
    """Check the masked Llama rounds: every step of the masked run took
    the flash kernels' launches, both parties masked every round with a
    grid, the masked run's final adapters equal the replay of its train
    outputs through plain rounds at both parties; print the walls, the
    keystream time and the masking overhead as bench.py defines it (the
    masked run's compressed-domain rounds against the plain run's, round
    0 being the unmasked bootstrap of both)."""
    for party, rep in (("alice", alice), ("bob", bob)):
        masked, replay = rep["round_secagg"], rep["round_secagg_replay"]
        if masked["masked_rounds"] != SECAGG_ROUNDS - 1:
            raise AssertionError(f"[round_secagg] {party} masked {masked['masked_rounds']} rounds, "
                                 f"want {SECAGG_ROUNDS - 1}")
        for step in masked["trainers"][party]["steps"]:
            if step["launches"] != want:
                raise AssertionError(f"[round_secagg] {party}'s step launched {step['launches']}, want {want}")
        if masked["digests"] != replay["digests"] or masked["digests"]["alice"] != masked["digests"]["bob"]:
            raise AssertionError(f"[round_secagg] the masked final differs from the plain replay at {party}: "
                                 f"{masked['digests']} vs {replay['digests']}")
    a = alice["round_secagg"]
    plain_s = alice["round_secagg_plain"]["round_s"][1:]
    masked_s = a["round_s"][1:]
    frac = min(masked_s) / min(plain_s) - 1.0
    print(f"[round_secagg] suite {a['suite'][0]}/{a['suite'][1]}; alice's SECAGG_STATS {json.dumps(a['stats'])}")
    print(f"[round_secagg] Llama-3-8B LoRA, 2 parties, {a['elements']} elements: masked final == plain replay "
          f"(sha256 {a['digests']['alice']['sha256'][:16]}) at both parties; round walls masked "
          f"{[round(t, 3) for t in a['round_s']]} s, plain {[round(t, 3) for t in alice['round_secagg_plain']['round_s']]} s "
          f"(round 0 unmasked in both); overhead frac {frac:.4f} (fastest masked over fastest plain "
          f"quantized round); mask_gen_ms {a['mask_gen_ms']:.2f} (alice's net mask, unhidden)")
    return {"overhead_frac": frac, "mask_gen_ms": a["mask_gen_ms"], "round_s": a["round_s"],
            "plain_round_s": alice["round_secagg_plain"]["round_s"], "suite": a["suite"]}


def _overlap_summary(a, b, want, tag):
    """Check both parties' reports of a pipelined part and print them: the
    launches of every step, equal final adapters on the card, the fold
    kernel where the part folds floats, every ring round completed as a ring
    and, in coordinator mode, the final adapters equal to the DGA recurrence
    replayed from the recorded train outputs."""
    rounds = a["rounds"]
    d = _check_session(a, b, want, tag, rounds)
    for party, r in (("alice", a), ("bob", b)):
        if r["replay"] is not None and r["replay"] != d:
            raise AssertionError(f"{tag}: {party}'s replay of the DGA recurrence {r['replay']['sha256'][:16]} "
                                 f"differs from the pipelined result {d['sha256'][:16]}")
    ring = "ring" in tag
    launches = {k: 0 for k in want}
    for party, r in (("alice", a), ("bob", b)):
        t = r["trainers"][party]
        for i, (step, rec) in enumerate(zip(t["steps"], r["timings"])):
            print(f"[{tag}] {party} round {i}: local_s {rec['local_s']:.3f} push_s {rec['push_s']:.3f} "
                  f"agg_s {rec['agg_s']:.3f} hidden_s {rec['hidden_s']:.3f}; step {step['step_ms']:.1f} ms "
                  f"loss {step['loss']:.6f} launches {step['launches']}")
            for k in launches:
                launches[k] += step["launches"][k]
        print(f"[{tag}] {party}: {rounds} rounds in {r['wall_s']:.2f} s wall, pushed "
              f"{[round(x / 1e6, 4) for x in r['pushed']]} MB, fold_fma launches {r['fold_launches']}, "
              f"ring {r['ring_stats']}")
        want_ring = {"rounds_completed": rounds if ring else 0, "rounds_aborted": 0, "fallback_rounds": 0}
        if r["ring_stats"] != want_ring:
            raise AssertionError(f"{tag}: {party}'s ring counters {r['ring_stats']}, want {want_ring}")
        if (ring or party == "alice") and not r["fold_launches"]:
            raise AssertionError(f"{tag}: {party}'s float folds never launched the fold kernel")
    print(f"[{tag}] final adapters sha256 {d['sha256'][:16]} on both parties"
          + (", equal to the replayed DGA recurrence" if a["replay"] is not None else "")
          + f"; launches over both parties' steps {launches}")
    return {"launches": launches, "fold_launches": a["fold_launches"] + b["fold_launches"],
            "wall_s": {"alice": a["wall_s"], "bob": b["wall_s"]}}


def _server_opt_round_summary(alice, bob, want, tag, base):
    """Check both parties' reports of a server-opt part and print them: the
    launches of every step, equal final adapters on the card, the state's
    SHA-256 equal at both parties after every resync and on the card; the
    walls per round beside the same run's part ``base`` without the
    optimizer."""
    a, b = alice[tag], bob[tag]
    rounds = a["rounds"]
    d = _check_session(a, b, want, tag, rounds)
    sa, sb = a["state_digests"], b["state_digests"]
    # A pipelined run resyncs as each round lands, the last one excepted.
    n_resync = rounds - 1 if "overlap" in tag else rounds
    if len(sa) != n_resync or sa != sb or any(m[2] != "cuda" for s in sa for m in s["meta"]):
        raise AssertionError(f"{tag}: server-opt state digests: alice {sa}, bob {sb} (want {n_resync}, equal, on "
                             f"the card)")
    launches = {k: 0 for k in want}
    for party, r in (("alice", a), ("bob", b)):
        t = r["trainers"][party]
        for i, (step, rec) in enumerate(zip(t["steps"], r["timings"])):
            print(f"[{tag}] {party} round {i}: local_s {rec['local_s']:.3f} push_s {rec['push_s']:.3f} "
                  f"agg_s {rec['agg_s']:.3f}; step {step['step_ms']:.1f} ms loss {step['loss']:.6f} "
                  f"launches {step['launches']}")
            for k in launches:
                launches[k] += step["launches"][k]
    per_round = {p: r[tag]["wall_s"] / rounds for p, r in (("alice", alice), ("bob", bob))}
    per_round_base = {p: r[base]["wall_s"] / r[base]["rounds"] for p, r in (("alice", alice), ("bob", bob))}
    print(f"[{tag}] state sha256 after each resync, equal at both parties on the card: "
          f"{[s['sha256'][:16] for s in sa]}; final adapters sha256 {d['sha256'][:16]}; launches over both "
          f"parties' steps {launches}; fold_fma launches: alice {a['fold_launches']}, bob {b['fold_launches']}")
    print(f"[{tag}] wall per round: {json.dumps(per_round)} s, beside {base} without the optimizer "
          f"{json.dumps(per_round_base)} s")
    return {"launches": launches, "fold_launches": a["fold_launches"] + b["fold_launches"],
            "wall_s": {"alice": a["wall_s"], "bob": b["wall_s"]}, "per_round_s": per_round,
            "base_per_round_s": per_round_base}


def _check_session(a, b, want, tag, rounds):
    """The checks every part of the round session shares: each party's
    ``rounds`` steps launched ``want``, and both parties hold the same final
    adapters, on the card.  Returns their fingerprint."""
    for party, r in (("alice", a), ("bob", b)):
        steps = r["trainers"][party]["steps"]
        if len(steps) != rounds or any(s["launches"] != want for s in steps):
            raise AssertionError(f"{tag}: {party}'s steps launched {[s['launches'] for s in steps]}, "
                                 f"want {want} x {rounds}")
    if a["digests"] != b["digests"] or a["digests"]["alice"] != a["digests"]["bob"]:
        raise AssertionError(f"{tag}: the parties' final adapters differ: {a['digests']} vs {b['digests']}")
    d = a["digests"]["alice"]
    if not d["meta"] or any(m[2] != "cuda" for m in d["meta"]):
        raise AssertionError(f"{tag}: final adapters not on the card: {d['meta']}")
    return d


def _round_summary(a, b, want, quant=False):
    """Check both parties' reports of a round session and print them."""
    tag = "round_quant" if quant else "round"
    d = _check_session(a, b, want, tag, ROUNDS)
    # Every round's contribution (bob's) and broadcast (alice's) go out on
    # their delta streams; from round 2 on each send diffs against the
    # stream's cached base and ships the changed 4 MB chunks only, or a
    # full frame when every chunk changed (the client's rule).
    for party, r in (("alice", a), ("bob", b)):
        frames = r["delta"]["delta_stream_frames"] + r["delta"]["delta_full_frames"]
        if frames != ROUNDS * (2 if quant else 1):  # the counts run on from the bf16 rounds
            raise AssertionError(f"{tag}: {party} sent {frames} frames on its delta stream, want {ROUNDS}: {r['delta']}")
    launches = {k: 0 for k in want}
    for party, r in (("alice", a), ("bob", b)):
        t = r["trainers"][party]
        for i, (step, rec) in enumerate(zip(t["steps"], r["timings"])):
            print(f"[{tag}] {party} round {i}: local_s {rec['local_s']:.3f} push_s {rec['push_s']:.3f} "
                  f"agg_s {rec['agg_s']:.3f}; step {step['step_ms']:.1f} ms loss {step['loss']:.6f} "
                  f"launches {step['launches']}")
            if rec.get("agg_stats"):
                print(f"[{tag}] alice's aggregator, round {i}: {json.dumps(rec['agg_stats'])}")
            for k in launches:
                launches[k] += step["launches"][k]
        print(f"[{tag}] {party}: {ROUNDS} rounds in {r['wall_s']:.2f} s wall, "
              f"max_memory_allocated {t['max_memory_allocated'] / 1e9:.2f} GB, delta {r['delta']}")
    print(f"[{tag}] final adapters sha256 {d['sha256'][:16]} ({d['nbytes'] / 1e6:.2f} MB in "
          f"{len(d['meta'])} tensors) on both parties; launches over both parties' steps {launches}; "
          f"fold_fma launches: alice {a['fold_launches']}, bob {b['fold_launches']}")
    if not a["fold_launches"]:
        raise AssertionError(f"{tag}: alice's float folds never launched the fold kernel")
    # bob's pushes, one per round, in payload bytes: bf16 packed adapters,
    # and under wire_quant from its second round uint8 codes plus the grid.
    pushed = b["pushed"]
    print(f"[{tag}] bob's pushed payloads per round: {[round(x / 1e6, 4) for x in pushed]} MB")
    if len(pushed) != ROUNDS or (quant and not pushed[-1] < 0.6 * pushed[0]):
        raise AssertionError(f"{tag}: bob's pushes {pushed}: want {ROUNDS}, the quantized ones under 0.6x bf16")
    return {"launches": launches, "fold_launches": a["fold_launches"] + b["fold_launches"],
            "wall_s": {"alice": a["wall_s"], "bob": b["wall_s"]}}


def _ring_round_summary(a, b, want):
    """Check both parties' reports of the ring session and print them: the
    launches of every step, equal final adapters on the card, and the fold
    kernel at both parties (each folds its own stripe)."""
    tag = "round_ring"
    d = _check_session(a, b, want, tag, ROUNDS)
    launches = {k: 0 for k in want}
    for party, r in (("alice", a), ("bob", b)):
        t = r["trainers"][party]
        for i, (step, rec) in enumerate(zip(t["steps"], r["timings"])):
            print(f"[{tag}] {party} round {i}: local_s {rec['local_s']:.3f} push_s {rec['push_s']:.3f} "
                  f"agg_s {rec['agg_s']:.3f}; step {step['step_ms']:.1f} ms loss {step['loss']:.6f} "
                  f"launches {step['launches']}")
            for k in launches:
                launches[k] += step["launches"][k]
        print(f"[{tag}] {party}: {ROUNDS} rounds in {r['wall_s']:.2f} s wall, ingress "
              f"{r['ingress'] / 1e6:.3f} MB, pushed {[round(x / 1e6, 4) for x in r['pushed']]} MB, "
              f"fold_fma launches {r['fold_launches']}, ring {r['ring_stats']}")
        if not r["fold_launches"]:
            raise AssertionError(f"{tag}: {party}'s stripe folds never launched the fold kernel")
        # Every round completed as a ring, none through the coordinator fallback.
        if r["ring_stats"] != {"rounds_completed": ROUNDS, "rounds_aborted": 0, "fallback_rounds": 0}:
            raise AssertionError(f"{tag}: {party}'s ring counters {r['ring_stats']}, want {ROUNDS} completed")
    print(f"[{tag}] final adapters sha256 {d['sha256'][:16]} on both parties; launches over both "
          f"parties' steps {launches}")
    return {"launches": launches, "fold_launches": a["fold_launches"] + b["fold_launches"],
            "wall_s": {"alice": a["wall_s"], "bob": b["wall_s"]}}


# -- the split path: BASELINE config #5 across two party processes ----------

SPLIT_TIMEOUT_S = 420  # hard limit on the split phase's party processes


def _split_session(fed, party, dev, cfg_name, cfg_kw, batch, seq):
    """One driver on both parties: bert_base's encoder and pooler at alice,
    its head and the labels at bob, through ``fl.SplitTrainer``.  Returns the
    party's report: per mode each step's ms, loss and alice's launch counts,
    and this party's pushes; both trainers' final fingerprints; bob's counts;
    peak memory."""
    from rayfed_tpu_torch.runtime import get_runtime

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cfg = getattr(bert, cfg_name)(**cfg_kw)
    params = bert.init_bert(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    enc_params, head_params = bert.split_params(params)

    def batch_ids():
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        return torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=dev)

    @fed.remote
    def load_ids(lo, hi):
        return batch_ids()[lo:hi].contiguous()

    @fed.remote
    def load_labels(lo, hi):
        return batch_ids()[lo:hi, 0] % 2  # the parity of the first token id

    @fed.remote
    def launches(_after):  # runs after its argument, the encoder actor's last call
        counts = _counts()
        _zero_counts()
        return counts

    @fed.remote
    def peak():
        return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    def encoder_apply(p, ids):
        return bert.apply_pooler(p, bert.apply_encoder(p, ids, cfg, attn_fn=flash_attention))

    def trainer(wire_dtype):
        return fl.SplitTrainer(encoder_party="alice", head_party="bob", encoder_params=enc_params,
                               encoder_apply=encoder_apply, head_params=head_params,
                               head_apply=bert.apply_head, loss_fn=softmax_cross_entropy,
                               lr=SPLIT_LR, wire_dtype=wire_dtype)

    mb = batch // SPLIT_MICRO
    whole = (load_ids.party("alice").remote(0, batch), load_labels.party("bob").remote(0, batch))
    micro = [(load_ids.party("alice").remote(i * mb, (i + 1) * mb),
              load_labels.party("bob").remote(i * mb, (i + 1) * mb)) for i in range(SPLIT_MICRO)]
    fed.get(launches.party("alice").remote(None))  # zero alice's counts before the path
    tm = get_runtime().transport
    trainers = {"f32": trainer(None)}
    report = {"modes": {}}
    for mode, n in SPLIT_MODES:
        if mode == "bf16_wire":
            trainers["bf16_wire"] = trainer(torch.bfloat16)
        t = trainers["bf16_wire" if mode == "bf16_wire" else "f32"]
        logged = tm.transfer_log.total_recorded
        steps = []
        for _ in range(n):
            _sync(dev)
            t0 = time.perf_counter()
            if mode == "pipelined":
                losses = [float(fed.get(x)) for x in t.step_pipelined([x for x, _ in micro], [y for _, y in micro])]
                loss = sum(losses) / len(losses)
            else:
                loss = float(fed.get(t.step(*whole)))
            counts = fed.get(launches.party("alice").remote(t.encoder_params()))
            steps.append({"ms": (time.perf_counter() - t0) * 1e3, "loss": loss, "launches": counts})
        sent, _ = tm.transfer_log.records_since(logged)
        report["modes"][mode] = {"steps": steps,
                                 "sent": [(r.nbytes, r.seconds) for r in sent if r.direction == "send"]}
    digest = fed.remote(_leaf_digest)
    report["digests"] = {}
    for name, t in trainers.items():
        enc_obj, head_obj = t.encoder_params(), t.head_params()
        report["digests"][name] = {p: fed.get([digest.party(p).remote(enc_obj), digest.party(p).remote(head_obj)])
                                   for p in FED_PARTIES}
    report["bob_launches"] = fed.get(launches.party("bob").remote(None))
    report["peak"] = dict(zip(FED_PARTIES, fed.get([peak.party(p).remote() for p in FED_PARTIES])))
    return report


def _split_party(party, port_list, device, cfg_name, cfg_kw, batch, seq, out):
    """A party process of the split phase; puts its report on ``out``."""
    import rayfed_tpu_torch as fed

    try:
        cluster = {p: {"address": f"127.0.0.1:{port}", "transport_options": {"local_link": "auto"}}
                   for p, port in zip(FED_PARTIES, port_list)}
        runtime = fed.init(address="local", cluster=cluster, party=party, device=device, **FED_INIT)
        report = _split_session(fed, party, runtime.transport.device, cfg_name, cfg_kw, batch, seq)
        fed.shutdown()
        out.put({"party": party, **report})
    except BaseException:
        out.put({"party": party, "error": traceback.format_exc()})
        raise


def _run_split(cfg_name, cfg_kw, batch, seq, device):
    """Spawn the split phase's parties.  Rehearse on the CPU at toy size:
    ``_run_split("BertConfig", dict(hidden_size=32, num_layers=2,
    num_heads=2, intermediate_size=64), 8, 16, "cpu")``."""
    return _spawn_parties(_split_party, (_free_ports(len(FED_PARTIES)), device, cfg_name, cfg_kw, batch, seq),
                          SPLIT_TIMEOUT_S)


def phase_split():
    """The split path at bert_base's full width and depth, two parties."""
    cfg = bert.bert_base()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reports = _run_split("bert_base", dict(dtype=torch.bfloat16), SPLIT_BATCH, SPLIT_LEN, None)
    wall = time.perf_counter() - t0
    return _split_summary(reports, cfg, wall)


def _split_summary(reports, cfg, wall):
    """Check both parties' reports of the split phase and print them."""
    alice, bob = reports["alice"], reports["bob"]
    # BERT's LayerNorm is no RMSNorm: no norm kernel launches.
    one = {"fwd": 2 * cfg.num_layers, "bwd_dq": cfg.num_layers, "bwd_dkv": cfg.num_layers, **dict.fromkeys(NORM_KEYS, 0)}
    total = {k: 0 for k in one}
    out = {"wall_s": wall, "modes": {}}
    for mode, n in SPLIT_MODES:
        steps = alice["modes"][mode]["steps"]
        micro = SPLIT_MICRO if mode == "pipelined" else 1
        want = {k: v * micro for k, v in one.items()}
        if len(steps) != n or any(st["launches"] != want for st in steps):
            raise AssertionError(f"split {mode}: alice's steps launched {[st['launches'] for st in steps]}, "
                                 f"want {want} per step")
        losses = [st["loss"] for st in steps]
        if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"split {mode}: losses {losses} not finite and falling")
        for k in total:
            total[k] += sum(st["launches"][k] for st in steps)
        ms = [st["ms"] for st in steps]
        steady = sorted(ms[1:] or ms)[len(ms[1:] or ms) // 2]
        itemsize = 2 if mode == "bf16_wire" else 4
        act = SPLIT_BATCH // micro * cfg.hidden_size * itemsize  # one push's raw bytes
        pushes = {}
        for party, what in (("alice", "activations"), ("bob", "gradients")):
            sent = [(b, sec) for b, sec in reports[party]["modes"][mode]["sent"] if b >= act]
            nbytes, secs = sum(b for b, _ in sent), sum(sec for _, sec in sent)
            pushes[what] = {"pushes": len(sent), "bytes_per_step": nbytes / n,
                            "ms_per_push": secs / max(1, len(sent)) * 1e3,
                            "gbps": nbytes / secs / 1e9 if secs else 0.0}
        print(f"[split] {mode}: {n} steps of {SPLIT_BATCH} x {SPLIT_LEN} tokens"
              f"{f' in {SPLIT_MICRO} microbatches' if micro > 1 else ''}: step ms {[round(x, 1) for x in ms]}, "
              f"steady {steady:.1f} ms ({1e3 / steady:.2f} steps/s, {SPLIT_BATCH * SPLIT_LEN * 1e3 / steady:.0f} tok/s); "
              f"losses {[round(x, 6) for x in losses]}; launches per step in alice {steps[0]['launches']}")
        for what, r in pushes.items():
            print(f"[split] {mode}: {what} {r['bytes_per_step'] / 1e3:.1f} kB payload per step in "
                  f"{r['pushes']} pushes, {r['ms_per_push']:.3f} ms per push ({r['gbps']:.3f} GB/s)")
        out["modes"][mode] = {"steady_ms": steady, "steps_per_s": 1e3 / steady, "losses": losses, **pushes}
    if any(bob["bob_launches"].values()):
        raise AssertionError(f"split: bob launched flash kernels {bob['bob_launches']}")
    for name in alice["digests"]:
        d = {p: r["digests"][name] for p, r in reports.items()}
        if d["alice"] != d["bob"] or d["alice"]["alice"] != d["alice"]["bob"]:
            raise AssertionError(f"split {name}: the parties' fingerprints of the final params differ")
        enc, head = d["alice"]["alice"]
        if any(m[2] != "cuda" for m in enc["meta"] + head["meta"]):
            raise AssertionError(f"split {name}: final params not on the card")
        print(f"[split] {name} trainer: encoder sha256 {enc['sha256'][:16]} ({enc['nbytes'] / 1e6:.1f} MB), "
              f"head sha256 {head['sha256'][:16]}, equal on both parties")
    print(f"[split] peak memory: alice {alice['peak']['alice'] / 1e9:.2f} GB, bob {alice['peak']['bob'] / 1e9:.2f} GB; "
          f"bob's flash launches {bob['bob_launches']}; launches in alice over the phase {total}; "
          f"{wall:.1f} s wall, party processes included")
    out.update(launches=total, peak=alice["peak"])
    return out


# -- the topologies: BASELINE config #3, four parties, hub / ring / quorum ---

TOPO_PARTIES = ("alice", "bob", "carol", "dave")
TOPO_TIMEOUT_S = 420  # hard limit on the topology phase's party processes
TOPO_ROUNDS, TOPO_QUANT_ROUNDS = 3, 2
# The hierarchy's parts: two regions of two, uint8 codes, each party
# weighted by its shard's image count; round 0 is the flat bootstrap.
HIER_ROUNDS = 4
HIER_PARTS = ("hier", "hier_flat", "hier_quorum")
HIER_BYTES_MAX = 1.25  # mean bytes a party sends and receives per tree round, over 2·|model| (bf16)
# BASELINE #3 under FedAC, each from the same start as the hierarchy's
# parts: the tree, then the flat quantized hub (TOPO_ROUNDS rounds each).
SOPT_TOPO_PARTS = (("sopt_hier", {"mode": "hierarchy", "region_size": 2}), ("sopt_flat", {"streaming_agg": True}))
RESNET_N, RESNET_HW, RESNET_LR = 32, 32, 0.05  # a CIFAR-10-shaped shard per party
RING_INGRESS_MAX = 0.4  # alice's share of cluster ingress in a ring round
QUANT_BYTES_MAX = 0.6  # a quantized ring round's bytes against a bf16 ring round's
QUORUM_K, QUORUM_DEADLINE_S = 2, 3.0
CRASH_EXIT = 3  # the exit code of a party the chaos schedule crashes
# The seeded chaos schedule of the quorum part: carol straggles 8 s in
# round 1, dave crashes at round 1, and the coordinator alice crashes after
# round 2's cutoff, before anyone has heard its result.
TOPO_CHAOS = {"seed": 11, "rules": [
    {"hook": "round", "party": "carol", "match": {"round": 1}, "op": "delay_ms", "value": 8000},
    {"hook": "round", "party": "dave", "match": {"round": 1}, "op": "crash_party"},
    {"hook": "announce", "party": "alice", "match": {"round": 2}, "op": "crash_party"},
]}
TOPO_INIT = dict(
    cross_silo_retry_policy={"maxAttempts": 30, "initialBackoff": "0.2s", "maxBackoff": "1s"},
    enable_waiting_for_other_parties_ready=True,
)
# Death is declared after two missed pings 0.5 s apart, well inside a
# round's deadline.
QUORUM_INIT = dict(
    cross_silo_retry_policy={"maxAttempts": 2, "initialBackoff": "0.2s", "maxBackoff": "0.5s"},
    enable_waiting_for_other_parties_ready=True, peer_health_interval_in_seconds=0.5,
    peer_death_pings=2, cross_silo_timeout_in_seconds=15, recv_backstop_in_seconds=60,
)


# Secure aggregation on BASELINE #3 (phase_secagg (b)): quorum rounds of
# the four ResNet-18 parties on uint8 codes, masked and then plain, under
# one schedule: dave crashes at round 1 (the first round with a grid), so
# its cutoff recovers his masks.  Each run is a runtime of its own.
SECAGG_QUORUM_K, SECAGG_QUORUM_ROUNDS = 3, 3
SECAGG_CHAOS = {"seed": 17, "rules": [
    {"hook": "round", "party": "dave", "match": {"round": 1}, "op": "crash_party"},
]}
SECAGG_RUNS = (("secagg_masked", True), ("secagg_plain", False))


def _secagg_quorum_runs(party, ports, device, params0, out):
    """The masked and the plain quorum run of BASELINE #3 in this party
    process; each puts a progress report (the round walls and log, the
    final digest, SECAGG_STATS) on ``out``.  dave's crash ends his run:
    its runtime goes down and he takes part in the next one."""
    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch import chaos
    from rayfed_tpu_torch.fl import quantize as qz
    from rayfed_tpu_torch.fl import secagg as sa

    for tag, secure in SECAGG_RUNS:
        chaos.install(SECAGG_CHAOS)
        qz.reset_compressors()
        cluster = {p: {"address": f"127.0.0.1:{port}"} for p, port in zip(TOPO_PARTIES, ports[tag])}
        dev = fed.init(address="local", cluster=cluster, party=party, device=device, **QUORUM_INIT).transport.device
        trainers = {p: fed.remote(_ResNetTrainer).party(p).remote(SEED + 1 + i, dev)
                    for i, p in enumerate(TOPO_PARTIES)}
        stats0, log, marks = dict(sa.SECAGG_STATS), [], [time.perf_counter()]
        rep = {"crashed": False}
        try:
            final = fl.run_fedavg_rounds(
                trainers, params0, rounds=SECAGG_QUORUM_ROUNDS, compress_wire=True, packed_wire=True,
                wire_quant="uint8", secure_agg=secure, quorum=SECAGG_QUORUM_K, round_deadline_s=QUORUM_DEADLINE_S,
                coordinator="alice", round_log=log, on_round=lambda r, _p: marks.append(time.perf_counter()),
            )
            rep.update(digest=_leaf_digest(final), log=log)
        except chaos.ChaosPartyCrash:
            rep["crashed"] = True
        rep["round_s"] = [b - a for a, b in zip(marks, marks[1:])]
        rep["stats"] = {k: sa.SECAGG_STATS[k] - stats0[k] for k in ("masked_rounds", "mask_recoveries",
                                                                     "recovered_seeds")}
        fed.shutdown()
        out.put({"party": party, "progress": True, tag: rep})
    chaos.install({"rules": []})


def _secagg_party(party, ports, device, out):
    """The masked and plain BASELINE #3 quorum runs alone, in a party
    process of their own (a rehearsal of phase_secagg (b)): ``ports`` maps
    each of SECAGG_RUNS' tags to four ports."""
    from rayfed_tpu_torch.models import resnet
    from rayfed_tpu_torch.utils.platform import resolve_device

    try:
        params0 = resnet.init_resnet(torch.Generator().manual_seed(SEED), resnet.resnet18(num_classes=10),
                                     device=resolve_device(device))
        _secagg_quorum_runs(party, ports, device, params0, out)
        out.put({"party": party})
    except BaseException:
        out.put({"party": party, "error": traceback.format_exc()})
        raise


class _ResNetTrainer:
    """A party's trainer of BASELINE config #3: ResNet-18 (10 classes), one
    SGD step per round on its own synthetic CIFAR-10-shaped shard — normal
    images from the party's seed, labels from a fixed random probe of their
    mean colour."""

    def __init__(self, seed, device):
        from rayfed_tpu_torch.models import resnet

        gen = torch.Generator().manual_seed(seed)
        x = torch.randn(RESNET_N, RESNET_HW, RESNET_HW, 3, generator=gen)
        probe = torch.randn(3, 10, generator=torch.Generator().manual_seed(0))
        self.x, self.y = x.to(device), torch.argmax(x.mean(dim=(1, 2)) @ probe, dim=-1).to(device)
        self.step = resnet.make_fed_train_step(resnet.resnet18(num_classes=10), lr=RESNET_LR)
        self.losses = []

    def train(self, bundle):
        out, loss = self.step(bundle, self.x, self.y)
        self.losses.append(float(loss))
        return out

    def report(self):
        losses, self.losses = self.losses, []
        return losses


def _topo_part(fed, party, trainers, params, rounds, kw):
    """One part of the topology phase: ``rounds`` rounds from ``params``.
    Returns the final params and this party's report: the round walls and
    timings, the bytes it sent and received per round and received in all,
    its fold and flash launches, its ring round counters and the final
    params' fingerprint."""
    from rayfed_tpu_torch.fl.hierarchy import HIER_STATS
    from rayfed_tpu_torch.fl.ring import RING_STATS
    from rayfed_tpu_torch.runtime import get_runtime

    tm = get_runtime().transport
    barrier = fed.remote(lambda: 0)
    fed.get([barrier.party(p).remote() for p in TOPO_PARTIES])

    def mark():
        stats = tm.get_stats()
        return time.perf_counter(), stats["send_bytes"], stats["receive_bytes"]

    marks, ring0, hier0 = [mark()], dict(RING_STATS), dict(HIER_STATS)
    in0 = marks[0][2]

    def on_round(r, _params):
        marks.append(mark())

    timings = []
    fold.fold_fma_.launches = 0
    _zero_counts()
    final = fl.run_fedavg_rounds(trainers, params, rounds=rounds, compress_wire=True, packed_wire=True,
                                 timings=timings, on_round=on_round, **kw)
    fold_launches, flash_launches = fold.fold_fma_.launches, _counts()
    fed.get([barrier.party(p).remote() for p in TOPO_PARTIES])
    return final, {
        "round_s": [b[0] - a[0] for a, b in zip(marks, marks[1:])],
        "sent": [b[1] - a[1] for a, b in zip(marks, marks[1:])],
        "received": [b[2] - a[2] for a, b in zip(marks, marks[1:])],
        "ingress": tm.get_stats()["receive_bytes"] - in0,
        "timings": timings,
        "fold_launches": fold_launches,
        "flash_launches": flash_launches,
        "ring_stats": {k: RING_STATS[k] - ring0[k] for k in RING_STATS},
        "hier_stats": {k: HIER_STATS[k] - hier0[k] for k in HIER_STATS},
        "losses": fed.get([trainers[p].report.remote() for p in TOPO_PARTIES])[TOPO_PARTIES.index(party)],
        "digest": _leaf_digest(final),
    }


def _topo_party(party, ports, device, out):
    """A party process of the topology phase: the hub, ring and quantized
    ring parts in one runtime, then the quorum part under the chaos
    schedule in a second one.  A party the schedule crashes reports and
    exits with CRASH_EXIT."""
    # The hub and the ring parts must train the same bytes from the same inputs.
    _deterministic()
    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch import chaos
    from rayfed_tpu_torch.fl import quorum as fq
    from rayfed_tpu_torch.models import resnet
    from rayfed_tpu_torch.runtime import get_runtime

    try:
        cluster = {p: {"address": f"127.0.0.1:{port}"} for p, port in zip(TOPO_PARTIES, ports["rounds"])}
        dev = fed.init(address="local", cluster=cluster, party=party, device=device, **TOPO_INIT).transport.device
        params0 = resnet.init_resnet(torch.Generator().manual_seed(SEED), resnet.resnet18(num_classes=10),
                                     device=dev)
        trainers = {p: fed.remote(_ResNetTrainer).party(p).remote(SEED + 1 + i, dev)
                    for i, p in enumerate(TOPO_PARTIES)}
        report = {"party": party, "parts": {}}
        report["elements"] = fl.pack_tree(params0, torch.bfloat16).buf.numel()
        _, report["parts"]["hub"] = _topo_part(fed, party, trainers, params0, TOPO_ROUNDS, {"streaming_agg": True})
        final, report["parts"]["ring"] = _topo_part(fed, party, trainers, params0, TOPO_ROUNDS, {"mode": "ring"})
        _, report["parts"]["ring_quant"] = _topo_part(fed, party, trainers, final, TOPO_QUANT_ROUNDS,
                                                      {"mode": "ring", "wire_quant": "uint8"})
        # The hierarchy (phase_hierarchy), each part from the same start
        # and a fresh codec residual: the tree, the flat quantized hub, the
        # tree under the quorum loop.
        from rayfed_tpu_torch.fl import quantize as qz

        hier_kw = {"wire_quant": "uint8", "weights": [RESNET_N] * len(TOPO_PARTIES)}
        for name, kw, rounds in (
            ("hier", {"mode": "hierarchy", "region_size": 2}, HIER_ROUNDS),
            ("hier_flat", {"streaming_agg": True}, HIER_ROUNDS),
            ("hier_quorum", {"mode": "hierarchy", "region_size": 2, "quorum": QUORUM_K,
                             "round_deadline_s": 30.0}, TOPO_ROUNDS),
        ):
            qz.reset_compressors()
            _, report["parts"][name] = _topo_part(fed, party, trainers, params0, rounds, {**hier_kw, **kw})
        for name, kw in SOPT_TOPO_PARTS:
            qz.reset_compressors()
            _, report["parts"][name] = _topo_part(fed, party, trainers, params0, TOPO_ROUNDS,
                                                  {**hier_kw, **kw, "server_opt": fl.fedac(1.0, 3.0, 0.5)})
        fed.shutdown()
        out.put({"party": party, "progress": True, **report})
        _secagg_quorum_runs(party, ports, device, params0, out)

        chaos.install(TOPO_CHAOS)
        cluster = {p: {"address": f"127.0.0.1:{port}"} for p, port in zip(TOPO_PARTIES, ports["quorum"])}
        fed.init(address="local", cluster=cluster, party=party, device=device, **QUORUM_INIT)
        trainers = {p: fed.remote(_ResNetTrainer).party(p).remote(SEED + 1 + i, dev)
                    for i, p in enumerate(TOPO_PARTIES)}
        tm, log, timings, marks = get_runtime().transport, [], [], [time.perf_counter()]

        def on_round(r, _params):
            marks.append(time.perf_counter())
            out.put({"party": party, "progress": True, "quorum_round": r,
                     "fold_launches": fold.fold_fma_.launches})

        fold.fold_fma_.launches = 0
        _zero_counts()
        in0 = tm.get_stats()["receive_bytes"]
        try:
            final = fl.run_fedavg_rounds(
                trainers, params0, rounds=TOPO_ROUNDS, compress_wire=True, packed_wire=True,
                quorum=QUORUM_K, round_deadline_s=QUORUM_DEADLINE_S, coordinator="alice",
                round_log=log, timings=timings, on_round=on_round,
            )
        except chaos.ChaosPartyCrash:
            # A crash as the schedule means it: sockets die, no goodbyes.
            out.put({"party": party, "crashed": True, "fold_launches": fold.fold_fma_.launches,
                     "flash_launches": _counts()})
            out.close()
            out.join_thread()
            os._exit(CRASH_EXIT)
        out.put({"party": party, "crashed": False, "log": log, "timings": timings,
                 "round_s": [b - a for a, b in zip(marks, marks[1:])],
                 "epoch": tm.roster.snapshot()[0], "stats": dict(fq.QUORUM_STATS),
                 "metrics": fed.metrics_snapshot()["quorum"], "ingress": tm.get_stats()["receive_bytes"] - in0,
                 "fold_launches": fold.fold_fma_.launches, "flash_launches": _counts(),
                 "digest": _leaf_digest(final)})
        fed.shutdown()
    except BaseException:
        out.put({"party": party, "error": traceback.format_exc()})
        raise


def phase_topologies():
    """BASELINE config #3 on the one card: four party processes train
    ResNet-18 on CIFAR-10-shaped shards and average over the hub, the ring
    and the quantized ring, then run quorum rounds through a straggler, a
    crash and a coordinator crash."""
    torch.cuda.empty_cache()
    ports = {k: _free_ports(len(TOPO_PARTIES)) for k in ("rounds", "quorum", *(t for t, _ in SECAGG_RUNS))}
    t0 = time.perf_counter()
    reports = _spawn_parties(_topo_party, (ports, None), TOPO_TIMEOUT_S, parties=TOPO_PARTIES,
                             exit_codes={"alice": CRASH_EXIT, "dave": CRASH_EXIT})
    return _topology_summary(reports, time.perf_counter() - t0)


def _topology_summary(reports, wall):
    """Check the four parties' reports of the topology phase and print them."""
    parts = {p: r["progress"][0]["parts"] for p, r in reports.items()}
    n_elems = reports["alice"]["progress"][0]["elements"]
    print(f"[topo] ResNet-18 (10 classes): {n_elems} packed elements, {n_elems * 2 / 1e6:.2f} MB bf16; "
          f"{len(TOPO_PARTIES)} parties, {RESNET_N} images of {RESNET_HW}x{RESNET_HW}x3 each per round")
    out = {"wall_s": wall, "fold_launches": {}, "flash_launches": {}}
    for name in ("hub", "ring", "ring_quant"):
        rep = {p: parts[p][name] for p in TOPO_PARTIES}
        digests = {p: r["digest"]["sha256"] for p, r in rep.items()}
        if len(set(digests.values())) != 1:
            raise AssertionError(f"[topo {name}] the parties' final params differ: {digests}")
        total_in = sum(r["ingress"] for r in rep.values())
        n_rounds = len(rep["alice"]["sent"])
        # Every ring round completed as a ring: an aborted one would have
        # been rerun through the coordinator with the same bytes.
        want_ring = {"rounds_completed": n_rounds if name != "hub" else 0, "rounds_aborted": 0,
                     "fallback_rounds": 0}
        for p, r in rep.items():
            for i, rec in enumerate(r["timings"]):
                print(f"[topo {name}] {p} round {i}: wall {r['round_s'][i]:.3f} s, local_s {rec['local_s']:.3f} "
                      f"push_s {rec['push_s']:.3f} agg_s {rec['agg_s']:.3f}, sent {r['sent'][i] / 1e6:.3f} MB, "
                      f"received {r['received'][i] / 1e6:.3f} MB")
            print(f"[topo {name}] {p}: ingress {r['ingress'] / 1e6:.3f} MB ({r['ingress'] / total_in:.3f} of "
                  f"the cluster's), fold_fma launches {r['fold_launches']}, flash launches {r['flash_launches']}, "
                  f"ring {r['ring_stats']}, losses {r['losses']}")
            if r["ring_stats"] != want_ring:
                raise AssertionError(f"[topo {name}] {p}'s ring counters {r['ring_stats']}, want {want_ring}")
        out[name] = {"ingress_share": {p: r["ingress"] / total_in for p, r in rep.items()},
                     "round_share": [{p: r["received"][i] / sum(q["received"][i] for q in rep.values())
                                      for p, r in rep.items()} for i in range(n_rounds)],
                     "sent_per_round": [sum(r["sent"][i] for r in rep.values()) for i in range(n_rounds)],
                     "round_s": rep["alice"]["round_s"], "digest": digests["alice"]}
        out["fold_launches"][name] = sum(r["fold_launches"] for r in rep.values())
        out["flash_launches"][name] = {k: sum(r["flash_launches"][k] for r in rep.values())
                                       for k in rep["alice"]["flash_launches"]}
    hub, ring, quant = out["hub"], out["ring"], out["ring_quant"]
    if ring["digest"] != hub["digest"]:
        raise AssertionError(f"[topo] the ring's final params {ring['digest'][:16]} differ from the hub's "
                             f"{hub['digest'][:16]}")
    share = ring["ingress_share"]["alice"]
    print(f"[topo] alice's share of cluster ingress: ring {share:.3f}, hub {hub['ingress_share']['alice']:.3f}")
    if share > RING_INGRESS_MAX:
        raise AssertionError(f"[topo] alice received {share:.3f} of the ring's cluster ingress (> {RING_INGRESS_MAX})")
    bf16_round = sum(ring["sent_per_round"]) / len(ring["sent_per_round"])
    q_round = quant["sent_per_round"][-1]  # the first quantized round has no grid yet and ships bf16
    print(f"[topo] cluster bytes per ring round: bf16 {bf16_round / 1e6:.3f} MB, uint8 {q_round / 1e6:.3f} MB "
          f"({q_round / bf16_round:.3f})")
    if not q_round < QUANT_BYTES_MAX * bf16_round:
        raise AssertionError(f"[topo] the quantized ring round sent {q_round} B, not < {QUANT_BYTES_MAX} x {bf16_round}")
    q_share = quant["round_share"][-1]["alice"]
    print(f"[topo] alice's share of cluster ingress in the uint8 ring round: {q_share:.3f}")
    if q_share > RING_INGRESS_MAX:
        raise AssertionError(f"[topo] alice received {q_share:.3f} of the uint8 ring round's cluster ingress "
                             f"(> {RING_INGRESS_MAX})")
    for p in TOPO_PARTIES:
        if not parts[p]["ring"]["fold_launches"]:
            raise AssertionError(f"[topo ring] {p}'s stripe folds never launched the fold kernel")
    out["hierarchy"] = _hierarchy_summary(parts, n_elems)
    out["server_opt"] = _server_opt_topo_summary(parts)
    for name in HIER_PARTS + tuple(n for n, _ in SOPT_TOPO_PARTS):
        out["fold_launches"][name] = sum(parts[p][name]["fold_launches"] for p in TOPO_PARTIES)
        out["flash_launches"][name] = {k: sum(parts[p][name]["flash_launches"][k] for p in TOPO_PARTIES)
                                       for k in parts["alice"][name]["flash_launches"]}

    # The quorum part: bob and carol survive; alice and dave crashed.
    crashed = sorted(p for p, r in reports.items() if r.get("crashed"))
    if crashed != ["alice", "dave"]:
        raise AssertionError(f"[topo quorum] crashed parties {crashed}, want alice and dave")
    bob, carol = reports["bob"], reports["carol"]
    if bob["digest"] != carol["digest"]:
        raise AssertionError("[topo quorum] bob's and carol's final params differ")
    log = bob["log"]
    if len(log) != TOPO_ROUNDS or carol["log"] != log:
        raise AssertionError(f"[topo quorum] round logs: bob {bob['log']}, carol {carol['log']}")
    if not set(log[1]["members"]) < set(log[1]["active"]):
        raise AssertionError(f"[topo quorum] round 1 aggregated {log[1]['members']} of {log[1]['active']}")
    for p, r in (("bob", bob), ("carol", carol)):
        if r["epoch"] < 2 or r["stats"]["coordinator_failovers"] < 1 or r["metrics"] != r["stats"]:
            raise AssertionError(f"[topo quorum] {p}: epoch {r['epoch']}, stats {r['stats']}, metrics {r['metrics']}")
        for i, rec in enumerate(r["timings"]):
            e = log[i]
            print(f"[topo quorum] {p} round {i}: wall {r['round_s'][i]:.3f} s, local_s {rec['local_s']:.3f} "
                  f"agg_s {rec['agg_s']:.3f}; epoch {e['epoch']}, coordinator {e['coordinator']}, "
                  f"members {e['members']} of {e['active']}")
        print(f"[topo quorum] {p}: roster epoch {r['epoch']}, {r['stats']}, ingress {r['ingress'] / 1e6:.3f} MB, "
              f"fold_fma launches {r['fold_launches']}")
    # Every coordinator folded on the card: alice in rounds 0 and 1 (her
    # last report before the crash), bob in round 2.
    alice_folds = max([m["fold_launches"] for m in reports["alice"].get("progress", []) if "quorum_round" in m] or [0])
    if not alice_folds or not bob["fold_launches"]:
        raise AssertionError(f"[topo quorum] fold launches: alice {alice_folds}, bob {bob['fold_launches']}")
    print(f"[topo quorum] fold_fma launches: alice {alice_folds} (rounds 0-1), bob {bob['fold_launches']}; "
          f"final sha256 {bob['digest']['sha256'][:16]} on bob and carol")
    out["fold_launches"]["quorum"] = alice_folds + bob["fold_launches"] + carol["fold_launches"]
    # Every party's flash launches, the crashed parties' up to their crash.
    out["flash_launches"]["quorum"] = {k: sum(r["flash_launches"][k] for r in reports.values())
                                       for k in bob["flash_launches"]}
    # ResNet-18 has no attention: the flash kernels launch nowhere here.
    flash = {name: c for name, c in out["flash_launches"].items() if any(c.values())}
    print(f"[topo] flash launches over all parties: {out['flash_launches']}")
    if flash:
        raise AssertionError(f"[topo] ResNet-18 rounds launched flash kernels: {flash}")
    out["quorum"] = {"log": log, "round_s": bob["round_s"], "epoch": bob["epoch"]}
    out["secagg"] = _secagg_quorum_summary(reports)
    out["elements"] = n_elems
    print(f"[topo] four parties, all parts in {wall:.1f} s, party processes included")
    return out


def _secagg_quorum_summary(reports):
    """Check the masked and plain quorum runs of BASELINE #3: dave crashed
    in both, round 1 aggregated the three survivors, the masked final's
    SHA-256 equals the plain one's at every survivor, alice (the
    coordinator) recovered masks; print the round walls of both runs."""
    runs = {tag: {p: next(m[tag] for m in r["progress"] if tag in m) for p, r in reports.items()}
            for tag, _ in SECAGG_RUNS}
    masked, plain = runs["secagg_masked"], runs["secagg_plain"]
    survivors = [p for p in TOPO_PARTIES if p != "dave"]
    for tag, run in runs.items():
        if not run["dave"]["crashed"] or any(run[p]["crashed"] for p in survivors):
            raise AssertionError(f"[secagg quorum] {tag}: crashed {[p for p in run if run[p]['crashed']]}")
        members = run["alice"]["log"][1]["members"]
        if sorted(members) != survivors:
            raise AssertionError(f"[secagg quorum] {tag}: round 1 aggregated {members}")
    for p in survivors:
        if masked[p]["digest"]["sha256"] != plain[p]["digest"]["sha256"]:
            raise AssertionError(f"[secagg quorum] {p}: masked final != plain final")
        if masked[p]["stats"]["masked_rounds"] < SECAGG_QUORUM_ROUNDS - 1:
            raise AssertionError(f"[secagg quorum] {p} masked {masked[p]['stats']} rounds")
    if masked["alice"]["stats"]["mask_recoveries"] < 1:
        raise AssertionError(f"[secagg quorum] alice recovered no masks: {masked['alice']['stats']}")
    if len({masked[p]["digest"]["sha256"] for p in survivors}) != 1:
        raise AssertionError("[secagg quorum] the survivors' finals differ")
    walls = {tag: run["alice"]["round_s"] for tag, run in runs.items()}
    ratio = sum(walls["secagg_masked"]) / sum(walls["secagg_plain"])
    ratio_masked = sum(walls["secagg_masked"][1:]) / sum(walls["secagg_plain"][1:])
    print(f"[secagg quorum] BASELINE #3, 4 parties, uint8, quorum {SECAGG_QUORUM_K}, dave crashed at round 1: "
          f"masked final == plain final (sha256 {masked['alice']['digest']['sha256'][:16]}) at "
          f"{', '.join(survivors)}; alice's SECAGG_STATS {masked['alice']['stats']}; round members "
          f"{[e['members'] for e in masked['alice']['log']]}")
    print(f"[secagg quorum] alice's round walls masked {[round(t, 3) for t in walls['secagg_masked']]} s, plain "
          f"{[round(t, 3) for t in walls['secagg_plain']]} s; masked/plain {ratio:.3f} (the three rounds), "
          f"{ratio_masked:.3f} (rounds 1-2, the masked ones; round 0 is the unmasked bootstrap)")
    return {"walls": walls, "ratio": ratio, "ratio_masked_rounds": ratio_masked, "stats": masked["alice"]["stats"]}


# -- the multi-level hierarchy: 16 virtual parties in this process ----------

HIER_ML_PARTIES = tuple(f"v{i:02d}" for i in range(16))
HIER_ML_REGION, HIER_ML_BRANCH, HIER_ML_WEIGHT = 4, 2, 32  # 4 leaf regions -> 2 interior nodes -> the root
HIER_ML_QUORUM, HIER_ML_DEADLINE_S = 3, 3.0
HIER_ML_LATE = "v05"  # a member of leaf region 1 (v04..v07), held past the region's deadline
HIER_ML_BACKSTOP_S = 300
HBM_BYTES_PER_S = PEAKS["SXM"][1]


class _IntFoldMeter:
    """Counts the compressed-domain fold's calls on this process's
    aggregators, keyed by the folded dtype: uint8 codes at the leaf stripe
    owners, the int16 leaf sums at the interior nodes, the int32 interior
    sums at the root.  Wraps ``fedavg.quantized_accum_kernel`` (a torch
    ``add_``, not a kernel of the port) for the rounds only; its device time
    per level is taken alone (``_int_fold_times``), since 16 parties' threads
    share one interpreter and would time their launch delays."""

    def __init__(self):
        import threading

        self.lock, self.calls, self.orig = threading.Lock(), {}, fedavg.quantized_accum_kernel

    def __enter__(self):
        def fold(acc, off, chunk, w):
            self.orig(acc, off, chunk, w)
            key = str(chunk.dtype).replace("torch.", "")
            with self.lock:
                n, elems = self.calls.get(key, (0, 0))
                self.calls[key] = (n + 1, elems + chunk.numel())

        fedavg.quantized_accum_kernel = fold
        return self

    def __exit__(self, *exc):
        fedavg.quantized_accum_kernel = self.orig

    def take(self):
        with self.lock:
            calls, self.calls = self.calls, {}
        return {dt: {"launches": n, "elements": e} for dt, (n, e) in calls.items()}


def _int_fold_times(dev, chunk_elems):
    """The integer fold of one full block at each level's dtype and weight,
    on the card alone: device ms per call (CUDA events over 20 calls)
    against its byte bound (the chunk read, the i32 accumulator read and
    written, at HBM rate)."""
    out = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    for dt, w, hi in (("uint8", HIER_ML_WEIGHT, 256), ("int16", 1, 1 << 14), ("int32", 1, 1 << 20)):
        chunk = torch.randint(0, hi, (chunk_elems,), generator=gen, device=dev).to(getattr(torch, dt))
        acc = torch.zeros(chunk_elems, dtype=torch.int32, device=dev)
        ms = _sync_ms(lambda: fedavg.quantized_accum_kernel(acc, 0, chunk, w), 20)
        out[dt] = {"ms": ms, "bound_ms": chunk_elems * (chunk.element_size() + 8) / HBM_BYTES_PER_S * 1e3}
    return out


def _hier_ml_round(mgrs, dev, contribs, grid, ref, keys, **kw):
    """One HierarchyRound on a thread per virtual party; returns per party
    (result, timings, seconds) and the managers' byte counts over the
    round."""
    import threading

    from rayfed_tpu_torch.fl import hierarchy as hier

    results, errors, timings, secs = {}, {}, {}, {}
    before = {p: (m.get_stats()["send_bytes"], m.get_stats()["receive_bytes"]) for p, m in mgrs.items()}
    late = kw.pop("late", None)

    def run(p):
        try:
            timings[p] = {}
            rnd = hier.HierarchyRound(
                mgrs[p], party=p, members=HIER_ML_PARTIES, region_size=HIER_ML_REGION, grid=grid, quant_ref=ref,
                keys=keys, weights={q: float(HIER_ML_WEIGHT) for q in HIER_ML_PARTIES}, stream="hml",
                backstop=HIER_ML_BACKSTOP_S, branch=HIER_ML_BRANCH, timings=timings[p], device=dev, **kw)
            if p == late:
                time.sleep(HIER_ML_DEADLINE_S + 2.0)
            t0 = time.perf_counter()
            results[p] = rnd.run(contribs[p])
            secs[p] = time.perf_counter() - t0
        except BaseException as e:  # reported below, with the party
            errors[p] = e

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(p,), daemon=True) for p in HIER_ML_PARTIES]
    for t in threads:
        t.start()
    for t in threads:
        t.join(HIER_ML_BACKSTOP_S)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise TimeoutError(f"[hier_ml] a party's round is still running after {HIER_ML_BACKSTOP_S} s")
    if errors:
        raise AssertionError(f"[hier_ml] parties failed: {errors}")
    moved = {p: (m.get_stats()["send_bytes"] - before[p][0], m.get_stats()["receive_bytes"] - before[p][1])
             for p, m in mgrs.items()}
    return results, timings, secs, moved, wall


def phase_hierarchy_multilevel(n_elems, device=None, chunk_elems=None):
    """A three-level tree in this process: 16 virtual parties, each a bare
    TransportManager on loopback driving ``HierarchyRound`` (region_size 4,
    branch 2: 4 leaf regions fold into 2 interior nodes, then the root), each
    contribution a ResNet-18-sized f32 buffer made on the card from the
    seed, weight 32, coded as uint8 on one shared grid.  Round 1 must equal
    ``packed_quantized_sum`` over the 16 on the card and on the CPU byte for
    byte, with int16 leaf sums and int32 interior sums; round 2 holds one
    member of leaf region 1 past its region's deadline under
    ``region_quorum=3`` and must equal the sum over the 15 that arrived, with
    a region cutoff and no aborted round."""
    from rayfed_tpu_torch.config import ClusterConfig, JobConfig, PartyConfig
    from rayfed_tpu_torch.fl import hierarchy as hier
    from rayfed_tpu_torch.fl import quantize as qz
    from rayfed_tpu_torch.transport.manager import TransportManager
    from rayfed_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    ref = 0.05 * torch.randn(n_elems, generator=gen, device=dev)
    contribs = {p: fl.pack_tree({"w": ref + 0.01 * torch.randn(n_elems, generator=gen, device=dev)}, torch.float32)
                for p in HIER_ML_PARTIES}
    prev = (0.01 * torch.randn(n_elems, generator=gen, device=dev)).cpu().numpy()
    grid = qz.make_round_grid(prev, mode="delta", expand=qz.QUANT_DELTA_EXPAND, chunk_elems=chunk_elems)
    qts = {p: qz.quantize_packed(c, grid, ref=ref) for p, c in contribs.items()}
    weights = [HIER_ML_WEIGHT] * len(HIER_ML_PARTIES)
    print(f"[hier_ml] {len(HIER_ML_PARTIES)} virtual parties, {n_elems} f32 elements each "
          f"({len(HIER_ML_PARTIES) * n_elems * 4 / 1e9:.3f} GB of contributions on {dev}), weight {HIER_ML_WEIGHT}, "
          f"uint8 on one grid of {grid.nblocks} blocks; region_size {HIER_ML_REGION}, branch {HIER_ML_BRANCH}")
    ports = _free_ports(len(HIER_ML_PARTIES))
    cluster = {p: PartyConfig.from_dict({"address": f"127.0.0.1:{port}"}) for p, port in zip(HIER_ML_PARTIES, ports)}
    mgrs = {p: TransportManager(ClusterConfig(parties=cluster, current_party=p),
                                JobConfig(cross_silo_timeout_s=120), device=dev)
            for p in HIER_ML_PARTIES}
    for m in mgrs.values():
        m.start()
    out = {}
    try:
        lay = hier.region_layout(HIER_ML_PARTIES, HIER_ML_REGION, branch=HIER_ML_BRANCH)
        root = lay.root
        rounds = ((1, {}, HIER_ML_PARTIES),
                  (2, {"region_quorum": HIER_ML_QUORUM, "region_deadline_s": HIER_ML_DEADLINE_S,
                       "late": HIER_ML_LATE}, tuple(p for p in HIER_ML_PARTIES if p != HIER_ML_LATE)))
        # The one-shot sums each round must give, on the card and the CPU.
        wants = {}
        for rnd, _, members in rounds:
            sub = [qts[p] for p in members]
            want = fedavg.packed_quantized_sum(sub, weights[:len(sub)], ref=ref)
            want_cpu = fedavg.packed_quantized_sum(sub, weights[:len(sub)], ref=ref.cpu())
            if not torch.equal(want.buf.cpu().view(torch.int32), want_cpu.buf.view(torch.int32)):
                raise AssertionError(f"[hier_ml] round {rnd}: packed_quantized_sum on {dev} differs from the CPU's")
            wants[rnd] = want_cpu.buf.view(torch.int32)
            del want
        stats0 = dict(hier.HIER_STATS)
        for rnd, kw, members in rounds:
            fold.fold_fma_.launches = 0
            _zero_counts()
            with _IntFoldMeter() as meter:
                results, timings, secs, moved, wall = _hier_ml_round(
                    mgrs, dev, contribs, grid, ref, [f"hml{rnd}.{j}" for j in range(hier.HIER_SEQ_IDS)], **kw)
            folds = meter.take()
            launches = {"fold_fma": fold.fold_fma_.launches, **_counts()}
            raw = wants[rnd]
            for p, got in results.items():
                if not torch.equal(got.buf.detach().cpu().view(torch.int32), raw):
                    raise AssertionError(f"[hier_ml] round {rnd}: {p}'s result differs from packed_quantized_sum "
                                         f"over {len(members)} parties")
            dtypes = {tuple(t["ps_dtypes"]) for t in timings.values()}
            if dtypes != {("int16", "int32")}:
                raise AssertionError(f"[hier_ml] round {rnd}: partial sums {dtypes}, want int16 leaves and "
                                     f"int32 interior nodes")
            ingress = max(moved, key=lambda p: moved[p][1])
            print(f"[hier_ml] round {rnd}: wall {wall:.3f} s (the parties' rounds {min(secs.values()):.3f}–"
                  f"{max(secs.values()):.3f} s), every party holds packed_quantized_sum over {len(members)} "
                  f"parties, equal on {dev.type} and cpu; partial sums: leaves int16, interior nodes int32, the "
                  f"root folds int32 (partial_sum_dtype(255, {HIER_ML_WEIGHT * len(HIER_ML_PARTIES)}) = "
                  f"{hier.partial_sum_dtype(grid.qabs_max, HIER_ML_WEIGHT * len(HIER_ML_PARTIES))})")
            print(f"[hier_ml] round {rnd}: root {root} egress {moved[root][0] / 1e6:.3f} MB, ingress "
                  f"{moved[root][1] / 1e6:.3f} MB; largest ingress {moved[ingress][1] / 1e6:.3f} MB at {ingress}; "
                  f"launches {launches}")
            for dt, f in sorted(folds.items()):
                print(f"[hier_ml] round {rnd}: integer fold of {dt} chunks: {f['launches']} launches, "
                      f"{f['elements']} elements")
            out[f"round{rnd}"] = {"wall_s": wall, "party_s": secs, "root_egress": moved[root][0],
                                  "max_ingress": [ingress, moved[ingress][1]], "folds": folds,
                                  "launches": launches}
        stats = {k: hier.HIER_STATS[k] - stats0[k] for k in stats0}
        print(f"[hier_ml] HIER_STATS over both rounds (all 16 parties): {stats}")
        if dev.type == "cuda":
            out["fold_times"] = _int_fold_times(dev, grid.chunk_elems)
            for dt, f in out["fold_times"].items():
                print(f"[hier_ml] integer fold of one {grid.chunk_elems}-element {dt} block alone: "
                      f"{f['ms']:.4f} ms on the card against a {f['bound_ms']:.4f} ms byte bound "
                      f"({f['bound_ms'] / f['ms']:.3f} of it)")
        if stats["rounds_aborted"] or stats["fallback_rounds"] or stats["region_cutoffs"] < 1:
            raise AssertionError(f"[hier_ml] counters {stats}: want no aborted round and >= 1 region cutoff")
        out["stats"] = stats
    finally:
        # In parallel: a manager's shutdown can wait out its peers' links.
        with ThreadPoolExecutor(len(mgrs)) as pool:
            list(pool.map(lambda m: m.stop(), mgrs.values()))
    del contribs, qts
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


# -- buffered asynchronous rounds: in-process virtual parties ---------------

# Leg 1, after the reference bench's async section: a quadratic toward a
# shared optimum, each step a fixed 50 ms of "compute", p4 slowed 2-10x by a
# seeded schedule; the thread-barrier sync loop against the async fleet.
ASYNC_PARTIES = ("coord", "p1", "p2", "p3", "p4")
ASYNC_DIM, ASYNC_BASE_S, ASYNC_LR, ASYNC_TARGET_FRAC, ASYNC_SYNC_ROUNDS = 4096, 0.05, 0.5, 0.05, 6
ASYNC_CHAOS = {"seed": 11, "rules": [{"hook": "local_step", "party": "p4", "op": "local_slowdown",
                                      "value": [2.0, 10.0]}]}
ASYNC_TT_FRAC = 0.8  # async_tt_frac: async time to target at most 0.8x the barrier's
ASYNC_N64 = 64  # leg 2: 1 coordinator + 63 members, 2 cycles each
ASYNC_VPS_MIN = 1.0  # async_versions_per_sec
# Legs 3-4: BASELINE config #3 asynchronous, a coordinator and 3 ResNet-18
# members on their 32-image shards; m3 runs 4x slower.
ASYNC_RESNET = ("coord", "m1", "m2", "m3")
ASYNC_RESNET_CHAOS = {"seed": 13, "rules": [{"hook": "local_step", "party": "m3", "op": "local_slowdown",
                                             "value": [4.0, 4.0]}]}
ASYNC_RESNET_CYCLES, ASYNC_RESNET_K, ASYNC_WEIGHT = 4, 2, 16


def _qt_on(qt, dev):
    """A QuantizedPackedTree with its codes on ``dev``."""
    from rayfed_tpu_torch.fl.quantize import QuantizedPackedTree

    return QuantizedPackedTree(fedavg.as_tensor(qt.buf, dev), qt.scales, qt.zps, qt.passthrough, qt.spec, qt.gmeta)


def _async_refold_means(vlog, folds, dev):
    """Each version's buffered mean (before any server step): the sorted
    refold of its folds on ``dev``, as a PackedTree."""
    import collections

    by_v = collections.defaultdict(list)
    for f in folds:
        if f["w_eff"] > 0:
            by_v[f["version"]].append(f)
    out, prev = [], None
    for rec in vlog:
        fset = sorted(by_v[rec["version"] - 1], key=lambda f: f["party"])
        if not fset:
            raise AssertionError(f"[async] version {rec['version']} folded nothing")
        qts = [_qt_on(f["qt"], dev) for f in fset]
        ref = None if qts[0].gmeta.mode != "delta" else torch.from_numpy(prev).to(dev)
        out.append(fedavg.packed_quantized_sum(qts, [f["w_eff"] for f in fset], ref=ref))
        prev = rec["model"]
    return out


def _async_check_refold(vlog, folds, tag, dev):
    """Every version byte-equal to its refold on ``dev`` (the card) and on
    the CPU (``async_refold_bitexact``)."""
    models = [torch.from_numpy(rec["model"]).view(torch.uint8) for rec in vlog]
    card, cpu = ([_raw(m.buf) for m in _async_refold_means(vlog, folds, torch.device(d))] for d in (dev, "cpu"))
    ok = bool(vlog) and all(torch.equal(a, m) and torch.equal(b, m) for a, b, m in zip(card, cpu, models))
    print(f"[async {tag}] {len(vlog)} versions, each byte-equal to the sorted refold of its folds on the card "
          f"and on the CPU: async_refold_bitexact {ok}")
    if not ok:
        raise AssertionError(f"[async {tag}] an emitted version differs from its refold")
    return ok


def _async_quadratic_legs(dev):
    """Legs 1 and 2 (the reference bench's): time to target under a
    straggler, async against the thread-barrier loop, and the 64-party
    throughput."""
    import threading

    from rayfed_tpu_torch import chaos
    from rayfed_tpu_torch.fl import async_rounds as ar
    from rayfed_tpu_torch.fl import quantize as qz

    gen = torch.Generator().manual_seed(7)
    c_host = 0.25 + 0.5 * torch.rand(ASYNC_DIM, generator=gen)
    w0 = torch.rand(ASYNC_DIM, generator=gen)
    c_vec = c_host.to(dev)

    def loss(w):
        return float(0.5 * ((torch.as_tensor(w).to(c_host.device) - c_host) ** 2).mean())

    target = ASYNC_TARGET_FRAC * loss(w0)
    members = [p for p in ASYNC_PARTIES if p != "coord"]

    def local_step(party, packed, version, cycle):
        buf = packed.buf.to(torch.float32)
        time.sleep(ASYNC_BASE_S)
        return fl.PackedTree(buf + ASYNC_LR * (c_vec[: buf.numel()] - buf), packed.passthrough, packed.spec)

    # Warm the codec and the fold outside the timed legs.
    ar.run_async_fleet(["coord", "p1"], {"w": w0}, local_step, cycles=2, buffer_k=1, timeout_s=120, device=dev)
    ar.reset_async_stats()
    qz.reset_compressors()

    chaos.install(ASYNC_CHAOS)
    barrier = threading.Barrier(len(members))
    model = {"w": w0.to(dev)}
    contribs, sync_curve = {}, []
    t0 = time.time()

    def sync_member(p):
        for rnd in range(ASYNC_SYNC_ROUNDS):
            w = model["w"]
            t1 = time.perf_counter()
            time.sleep(ASYNC_BASE_S)
            new = w + ASYNC_LR * (c_vec - w)
            chaos.fire("local_step", p, version=rnd, cycle=rnd, baseline_s=time.perf_counter() - t1)
            contribs[p] = new
            if barrier.wait() == 0:
                model["w"] = torch.stack([contribs[m] for m in members]).mean(dim=0)
                sync_curve.append((time.time() - t0, loss(model["w"].cpu())))
            barrier.wait()

    threads = [threading.Thread(target=sync_member, args=(p,), daemon=True) for p in members]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    chaos.uninstall()
    tt_sync = next((t for t, lo in sync_curve if lo <= target), None)

    chaos.install(ASYNC_CHAOS)
    vlog, folds = [], []
    t0 = time.time()
    out = ar.run_async_fleet(ASYNC_PARTIES, {"w": w0}, local_step, cycles={"p1": 10, "p2": 10, "p3": 10, "p4": 4},
                             weights={p: ASYNC_WEIGHT for p in members}, buffer_k=3, timeout_s=120,
                             version_log=vlog, record_folds=folds, device=dev)
    chaos.uninstall()
    hist = dict(ar.ASYNC_STATS["staleness_hist"])
    tt_async = next((r["t_wall"] - t0 for r in vlog if loss(torch.from_numpy(r["model"][:ASYNC_DIM])) <= target), None)
    frac = None if tt_async is None or not tt_sync else tt_async / tt_sync
    print(f"[async quadratic] time to target (excess loss <= {ASYNC_TARGET_FRAC} of the initial, p4 slowed "
          f"2-10x): sync barrier {tt_sync} s over {len(sync_curve)} rounds, async {tt_async} s; "
          f"async_tt_frac {frac} (gate <= {ASYNC_TT_FRAC}); {out['versions']} versions from {out['folds']} folds, "
          f"staleness histogram {hist}")
    if frac is None or frac > ASYNC_TT_FRAC:
        raise AssertionError(f"[async quadratic] async_tt_frac {frac}: sync {tt_sync} s, async {tt_async} s")
    bitexact = _async_check_refold(vlog, folds, "quadratic", dev)

    ar.reset_async_stats()
    qz.reset_compressors()
    n64 = ["coord"] + [f"m{i:02d}" for i in range(ASYNC_N64 - 1)]

    def fast_step(party, packed, version, cycle):
        buf = packed.buf.to(torch.float32)
        return fl.PackedTree(buf + ASYNC_LR * (c_vec[: buf.numel()] - buf), packed.passthrough, packed.spec)

    t1 = time.time()
    out64 = ar.run_async_fleet(n64, {"w": w0[:256]}, fast_step, cycles=2,
                               weights={p: ASYNC_WEIGHT for p in n64[1:]}, buffer_k=8, timeout_s=240, device=dev)
    wall64 = time.time() - t1
    vps = out64["versions"] / wall64
    print(f"[async n64] {ASYNC_N64} virtual parties ({ASYNC_N64 - 1} members, 2 cycles each, no chaos): "
          f"{out64['versions']} versions from {out64['folds']} folds in {wall64:.3f} s; async_versions_per_sec "
          f"{vps:.3f} (gate >= {ASYNC_VPS_MIN})")
    if vps < ASYNC_VPS_MIN:
        raise AssertionError(f"[async n64] async_versions_per_sec {vps}")
    return {"tt_sync_s": tt_sync, "tt_async_s": tt_async, "tt_frac": frac, "versions": out["versions"],
            "folds": out["folds"], "staleness_hist": hist, "refold_bitexact": bitexact,
            "n64_versions": out64["versions"], "n64_wall_s": wall64, "versions_per_sec": vps}


class _AsyncResNetStep:
    """The members' local step of the asynchronous BASELINE #3: one SGD step
    of ResNet-18 on the member's 32 seeded CIFAR-10-shaped images, on the
    card, f32 packed in and out."""

    def __init__(self, dev):
        from rayfed_tpu_torch.models import resnet

        self.data = {}
        for i, p in enumerate(ASYNC_RESNET[1:]):
            gen = torch.Generator().manual_seed(SEED + 1 + i)
            x = torch.randn(RESNET_N, RESNET_HW, RESNET_HW, 3, generator=gen)
            probe = torch.randn(3, 10, generator=torch.Generator().manual_seed(0))
            self.data[p] = (x.to(dev), torch.argmax(x.mean(dim=(1, 2)) @ probe, dim=-1).to(dev))
        self.step = resnet.make_fed_train_step(resnet.resnet18(num_classes=10), lr=RESNET_LR,
                                               wire_dtype=torch.float32)

    def __call__(self, party, packed, version, cycle):
        x, y = self.data[party]
        out, _ = self.step(packed, x, y)
        return out


def _async_resnet_leg(dev, params0, step, cycles, server_opt=None):
    from rayfed_tpu_torch import chaos
    from rayfed_tpu_torch.fl import async_rounds as ar
    from rayfed_tpu_torch.fl import quantize as qz

    ar.reset_async_stats()
    qz.reset_compressors()
    chaos.install(ASYNC_RESNET_CHAOS)
    vlog, folds = [], []
    fold.fold_fma_.launches = 0
    _zero_counts()
    t0 = time.time()
    try:
        out = ar.run_async_fleet(ASYNC_RESNET, params0, step, cycles=cycles,
                                 weights={p: ASYNC_WEIGHT for p in ASYNC_RESNET[1:]}, buffer_k=ASYNC_RESNET_K,
                                 server_opt=server_opt, timeout_s=300, version_log=vlog, record_folds=folds,
                                 device=dev)
    finally:
        chaos.uninstall()
    wall = time.time() - t0
    return out, vlog, folds, wall, {"fold_fma": fold.fold_fma_.launches, **_counts()}, dict(ar.ASYNC_STATS)


def phase_async(card, device=None):
    """Buffered asynchronous rounds, ``run_async_fleet`` with in-process
    virtual parties (the JAX package's own harness: a thread per party over
    bare TransportManagers, the buffer and the models on the card).  Leg 1:
    time to target under a straggler, async against the barrier
    (``async_tt_frac``), every version byte-equal to its refold on the card
    and the CPU; leg 2: 64 parties' version rate; leg 3: BASELINE #3
    asynchronous (ResNet-18 members, one 4x slower), every version refolded,
    stale folds, no flash launch; leg 4: leg 3 under server momentum, the
    emitted models equal to the step replayed on the card from the
    versions' refolds.  ``device`` (default the card) lets the CPU rehearse
    it, without the fold's device time."""
    import numpy as np

    from rayfed_tpu_torch.fl import server_opt
    from rayfed_tpu_torch.models import resnet
    from rayfed_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    _, (_, hbm) = _peaks(card)
    out = {"quadratic": _async_quadratic_legs(dev)}

    params0 = resnet.init_resnet(torch.Generator().manual_seed(SEED), resnet.resnet18(num_classes=10), device=dev)
    step = _AsyncResNetStep(dev)
    res, vlog, folds, wall, launches, stats = _async_resnet_leg(dev, params0, step, ASYNC_RESNET_CYCLES)
    hist = stats["staleness_hist"]
    walls = [b["t_wall"] - a["t_wall"] for a, b in zip(vlog, vlog[1:])]
    vps = res["versions"] / wall
    print(f"[async resnet] {len(ASYNC_RESNET) - 1} ResNet-18 members x {ASYNC_RESNET_CYCLES} cycles, buffer_k "
          f"{ASYNC_RESNET_K}, m3 4x slower: {res['versions']} versions from {res['folds']} folds in {wall:.3f} s "
          f"({vps:.3f} versions/s); gaps between versions {[round(w, 3) for w in walls]} s; staleness histogram "
          f"{hist}; re-coded stale {stats['recoded_stale']}, decayed out {stats['dropped_decayed_out']}; launches "
          f"{launches}")
    _async_check_refold(vlog, folds, "resnet", dev)
    if not any(int(s) >= 1 for s in hist):
        raise AssertionError(f"[async resnet] no stale fold: staleness histogram {hist}")
    if any(launches[k] for k in ("fwd", "bwd_dq", "bwd_dkv")):
        raise AssertionError(f"[async resnet] ResNet-18 launched flash kernels: {launches}")
    n = int(vlog[0]["model"].size)
    fold_ms, fold_bound = None, n * 9 / hbm * 1e3  # the codes read, the i32 accumulator read and written
    if dev.type == "cuda":
        codes = torch.randint(0, 256, (n,), generator=torch.Generator(device=dev).manual_seed(SEED), device=dev,
                              dtype=torch.uint8)
        acc = torch.zeros(n, dtype=torch.int32, device=dev)
        fold_ms = _sync_ms(lambda: fedavg.quantized_accum_kernel(acc, 0, codes, ASYNC_WEIGHT), 20)
        print(f"[async resnet] the buffer's fold of one contribution ({n} uint8 codes into the i32 accumulator) "
              f"alone on the card: {fold_ms:.4f} ms against a {fold_bound:.4f} ms byte bound "
              f"({fold_bound / fold_ms:.3f} of it)")
        del codes, acc
    out["resnet"] = {"versions": res["versions"], "folds": res["folds"], "wall_s": wall, "versions_per_sec": vps,
                     "version_gaps_s": walls, "staleness_hist": hist, "launches": launches,
                     "fold_ms": fold_ms, "fold_bound_ms": fold_bound}

    opt = fl.server_momentum(1.0, 0.9)
    res, vlog, folds, wall, launches4, _ = _async_resnet_leg(dev, params0, step, 2, server_opt=opt)
    replica = fl.PackedServerOptimizer(opt, device=dev)
    model = fl.pack_tree(params0, torch.float32).buf.to(dev)
    ref_model, ref_state = model.cpu().numpy(), [np.zeros(n, np.float32)]
    refolds = _async_refold_means(vlog, folds, dev)
    worst = 0.0
    for rec, mean in zip(vlog, refolds):
        replica.ensure(model)
        stepped = replica.step_fn(model)(mean)
        replica.resync(model, stepped.buf)
        if not torch.equal(_raw(stepped.buf), torch.from_numpy(rec["model"]).view(torch.uint8)):
            raise AssertionError(f"[async server_opt] version {rec['version']}: the emitted model differs from the "
                                 f"step replayed on the card")
        ref_model, ref_state = server_opt.reference_step(opt, ref_model, mean.buf.cpu().numpy(), ref_state)
        worst = max(worst, float(np.abs(ref_model - rec["model"]).max()))
        model = stepped.buf
    print(f"[async server_opt] server_momentum(1.0, 0.9), {res['versions']} versions from {res['folds']} folds in "
          f"{wall:.3f} s: every emitted model equals the step and resync replayed on the card from the "
          f"versions' refolds, byte for byte; the numpy reference_step within {worst:.3e}; launches {launches4}")
    if not worst <= 1e-4:
        raise AssertionError(f"[async server_opt] reference_step differs by {worst}")
    out["server_opt"] = {"versions": res["versions"], "wall_s": wall, "launches": launches4,
                         "reference_step_max_err": worst}
    out["launches"] = {k: launches[k] + launches4[k] for k in launches}
    del params0, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _server_opt_topo_summary(parts):
    """BASELINE #3 under ``server_opt=fedac(1.0, 3.0, 0.5)``: the tree and
    the flat quantized hub from the same start.  Each part's final params
    equal at all four parties and equal between the parts; every tree round
    completed as a tree (no abort, no fallback)."""
    out = {}
    for name, _ in SOPT_TOPO_PARTS:
        rep = {p: parts[p][name] for p in TOPO_PARTIES}
        digests = {p: r["digest"]["sha256"] for p, r in rep.items()}
        if len(set(digests.values())) != 1:
            raise AssertionError(f"[topo {name}] the parties' final params differ: {digests}")
        for p, r in rep.items():
            for i, rec in enumerate(r["timings"]):
                print(f"[topo {name}] {p} round {i}: wall {r['round_s'][i]:.3f} s, local_s {rec['local_s']:.3f} "
                      f"push_s {rec['push_s']:.3f} agg_s {rec['agg_s']:.3f}, sent {r['sent'][i] / 1e6:.3f} MB, "
                      f"received {r['received'][i] / 1e6:.3f} MB")
            hs = r["hier_stats"]
            want = {"rounds_completed": TOPO_ROUNDS - 1 if name == "sopt_hier" else 0, "rounds_aborted": 0,
                    "fallback_rounds": 0, "region_cutoffs": 0}
            print(f"[topo {name}] {p}: HIER_STATS {hs}, fold_fma launches {r['fold_launches']}, flash launches "
                  f"{r['flash_launches']}, losses {r['losses']}")
            if hs != want:
                raise AssertionError(f"[topo {name}] {p}'s hierarchy counters {hs}, want {want}")
        out[name] = {"digest": digests["alice"], "round_s": rep["alice"]["round_s"]}
    if out["sopt_hier"]["digest"] != out["sopt_flat"]["digest"]:
        raise AssertionError(f"[topo server_opt] the tree's final params {out['sopt_hier']['digest'][:16]} differ "
                             f"from the flat quantized hub's {out['sopt_flat']['digest'][:16]} under FedAC")
    print(f"[topo server_opt] under fedac(1.0, 3.0, 0.5) the tree's final params equal the flat quantized hub's at "
          f"all four parties: sha256 {out['sopt_hier']['digest'][:16]}")
    return out


def _hierarchy_summary(parts, n_elems):
    """phase_hierarchy, BASELINE config #3 under ``mode="hierarchy"`` (run in
    the topology phase's party processes): check the three hierarchy parts
    and print them.  The tree's final params equal the flat quantized hub's
    at every party; every tree round completed as a tree (round 0 is the
    flat bootstrap); the quorum loop's tree rounds never fell back; a party
    sends and receives at most HIER_BYTES_MAX x 2·|model| per tree round,
    over the tree rounds after the first (the coordinator's bootstrap
    broadcast completes inside the first tree round's window)."""
    model_bytes = 2 * n_elems  # the bf16 bundle
    out = {}
    for name in HIER_PARTS:
        rep = {p: parts[p][name] for p in TOPO_PARTIES}
        digests = {p: r["digest"]["sha256"] for p, r in rep.items()}
        if len(set(digests.values())) != 1:
            raise AssertionError(f"[hier {name}] the parties' final params differ: {digests}")
        n_rounds = len(rep["alice"]["sent"])
        tree_rounds = 0 if name == "hier_flat" else n_rounds - 1
        for p, r in rep.items():
            total_in = [sum(q["received"][i] for q in rep.values()) for i in range(n_rounds)]
            for i, rec in enumerate(r["timings"]):
                print(f"[hier {name}] {p} round {i}: wall {r['round_s'][i]:.3f} s, local_s {rec['local_s']:.3f} "
                      f"push_s {rec['push_s']:.3f} agg_s {rec['agg_s']:.3f}, sent {r['sent'][i] / 1e6:.3f} MB, "
                      f"received {r['received'][i] / 1e6:.3f} MB ({r['received'][i] / total_in[i]:.3f} of the "
                      f"cluster's ingress), partial sums {rec.get('ps_dtypes', 'none (flat)')}")
            hs = r["hier_stats"]
            print(f"[hier {name}] {p}: HIER_STATS {hs}, fold_fma launches {r['fold_launches']}, flash launches "
                  f"{r['flash_launches']}, losses {r['losses']}")
            want = {"rounds_completed": tree_rounds, "rounds_aborted": 0, "fallback_rounds": 0, "region_cutoffs": 0}
            if hs != want:
                raise AssertionError(f"[hier {name}] {p}'s hierarchy counters {hs}, want {want}")
            dtypes = {tuple(rec["ps_dtypes"]) for rec in r["timings"] if "ps_dtypes" in rec}
            if tree_rounds and dtypes != {("int16",)}:
                raise AssertionError(f"[hier {name}] {p}'s partial sums rode {dtypes}, want int16 (255 x 64)")
        per_party = [(r["sent"][i] + r["received"][i]) for r in rep.values() for i in range(2, n_rounds)]
        frac = sum(per_party) / len(per_party) / (2 * model_bytes)
        out[name] = {"digest": digests["alice"], "round_s": rep["alice"]["round_s"], "bytes_frac": frac,
                     "bytes_per_party_round": sum(per_party) / len(per_party)}
        print(f"[hier {name}] mean bytes a party sent and received per round from round 2: "
              f"{sum(per_party) / len(per_party) / 1e6:.3f} MB, {frac:.3f} of 2·|model| "
              f"({2 * model_bytes / 1e6:.2f} MB)")
        if name == "hier" and frac > HIER_BYTES_MAX:
            raise AssertionError(f"[hier] a party moved {frac:.3f} x 2·|model| per tree round (> {HIER_BYTES_MAX})")
    if out["hier"]["digest"] != out["hier_flat"]["digest"]:
        raise AssertionError(f"[hier] the tree's final params {out['hier']['digest'][:16]} differ from the flat "
                             f"quantized hub's {out['hier_flat']['digest'][:16]}")
    print(f"[hier] the tree's final params equal the flat quantized hub's: sha256 {out['hier']['digest'][:16]}")
    return out


def _named_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def phase_split_grads(gen):
    """The split encoder's gradients through the kernels vs through dense
    attention, at depth 2 and full width, in one process."""
    cfg = dataclasses.replace(bert.bert_base(dtype=torch.bfloat16), num_layers=SPLIT_GRAD_LAYERS)
    enc, head = bert.split_params(bert.init_bert(cfg, gen, device="cuda"))
    ids = torch.randint(0, cfg.vocab_size, (SPLIT_BATCH, SPLIT_LEN), generator=gen, device="cuda")
    labels = ids[:, 0] % 2
    out = {}
    for name, fn in (("flash", flash_attention), ("dense", dot_product_attention)):
        def loss_fn(p, fn=fn):
            pooled = bert.apply_pooler(p, bert.apply_encoder(p, ids, cfg, attn_fn=fn))
            return softmax_cross_entropy(bert.apply_head(head, pooled), labels)

        out[name] = value_and_grad(loss_fn, enc)
    worst, worst_at = 0.0, None
    flat = {k: dict(_named_leaves(out[k][1])) for k in out}
    for path, g_dense in flat["dense"].items():
        gap = (flat["flash"][path].float() - g_dense.float()).abs().max().item()
        span = g_dense.float().abs().max().item()
        if path.endswith("attn/bk"):
            # Zero but for rounding on both paths: a shift of every key by one
            # vector moves a query's scores by one constant, which softmax
            # cancels.  Held against the query bias's gradient instead.
            span = flat["dense"][path[:-2] + "bq"].float().abs().max().item()
            noise = max(flat[k][path].float().abs().max().item() for k in flat)
            if not noise <= GRAD_REL_TOL * span:
                raise AssertionError(f"{path}: |g| {noise:.4e} is not zero against max|g(bq)| {span:.4e}")
            continue
        if not (span > 0 and gap <= GRAD_REL_TOL * span):
            raise AssertionError(f"encoder gradient {path} through flash disagrees with dense: "
                                 f"gap {gap:.4e}, max|g| {span:.4e}")
        if gap / span > worst:
            worst, worst_at = gap / span, path
    print(f"[split grads] depth {SPLIT_GRAD_LAYERS} B={SPLIT_BATCH} T={SPLIT_LEN}: {len(flat['dense'])} encoder "
          f"gradients, flash vs dense within {GRAD_REL_TOL:g}*max|g| each; worst {worst:.4f} of max|g| "
          f"({worst_at}); loss flash={out['flash'][0].item():.6f} dense={out['dense'][0].item():.6f}")
    del enc, head, out, flat
    torch.cuda.empty_cache()
    return worst


# -- HF interop: a Llama-3-8B-width state dict on the card, and back --------

HF_LAYERS = 2


def _to_hf_state(params, cfg):
    """The port's Llama params as a Hugging Face ``LlamaForCausalLM`` state
    dict, on their device: the inverse of ``models.hf.from_hf_llama`` (each
    projection transposed back to ``[out, in]``, ``wq``/``wk`` un-permuted
    from the interleaved RoPE layout to the half-split one)."""
    dh = cfg.head_dim
    inv = torch.argsort(hf._rope_perm(dh))

    def unpermute(w, heads):  # [in, H·Dh] interleaved -> [H·Dh, in] half-split
        d_in = w.shape[0]
        return w.reshape(d_in, heads, dh)[:, :, inv.to(w.device)].reshape(d_in, heads * dh).t().contiguous()

    lay = params["layers"]
    state = {"model.embed_tokens.weight": params["embed"], "model.norm.weight": params["final_norm"]}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        state[p + "input_layernorm.weight"] = lay["attn_norm"][i]
        state[p + "self_attn.q_proj.weight"] = unpermute(lay["wq"][i], cfg.num_heads)
        state[p + "self_attn.k_proj.weight"] = unpermute(lay["wk"][i], cfg.num_kv_heads)
        state[p + "self_attn.v_proj.weight"] = lay["wv"][i].t().contiguous()
        state[p + "self_attn.o_proj.weight"] = lay["wo"][i].t().contiguous()
        state[p + "post_attention_layernorm.weight"] = lay["mlp_norm"][i]
        state[p + "mlp.gate_proj.weight"] = lay["w_gate"][i].t().contiguous()
        state[p + "mlp.up_proj.weight"] = lay["w_up"][i].t().contiguous()
        state[p + "mlp.down_proj.weight"] = lay["w_down"][i].t().contiguous()
    if not cfg.tie_embeddings:
        state["lm_head.weight"] = params["lm_head"].t().contiguous()
    return state


def phase_hf(gen):
    """``from_hf_llama`` on a 2-layer Llama-3-8B-width state dict on the card
    must give the port's params back exactly, on the card."""
    cfg = llama.llama3_8b(num_layers=HF_LAYERS, param_dtype=torch.float32)
    params = llama.init_llama(cfg, gen, device="cuda")
    state = _to_hf_state(params, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    back, _ = hf.from_hf_llama(state, config=cfg)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    from rayfed_tpu_torch import tree_util

    mine, got = tree_util.tree_leaves(params), tree_util.tree_leaves(back)
    nbytes = sum(t.numel() * t.element_size() for t in mine)
    exact = len(mine) == len(got) and all(
        a.device.type == "cuda" and a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, mine))
    print(f"[hf] from_hf_llama on a {HF_LAYERS}-layer llama3_8b-width state dict on the card "
          f"({len(state)} tensors, {nbytes / 1e9:.2f} GB f32): {ms:.1f} ms; params back exactly, on the card: {exact}")
    if not exact:
        raise AssertionError("from_hf_llama did not give the params back exactly on the card")
    del params, state, back, mine, got
    torch.cuda.empty_cache()
    return {"ms": ms, "nbytes": nbytes}


# phase_secagg: the masked steps at ResNet-18's size, and the robust
# reducers and the DP clip over four ResNet-18 contributions.
SECAGG_ELEMS = 11_183_562
SECAGG_GROUP_KEY = "chip-smoke-secagg-group-key"
DP_CLIP, DP_RTOL = 1.0, 1e-5  # the card's norm sums in PyTorch's order: held to 1e-5 relative


def _secagg_suite():
    """The negotiated secure-aggregation suite; without ``cryptography``
    the nonce/philox suite needs a group key, set here for every party
    process this script starts."""
    from rayfed_tpu_torch.transport.secagg import HAVE_X25519, KeyAgreement

    if not HAVE_X25519:
        os.environ.setdefault("RAYFED_SECAGG_GROUP_KEY", SECAGG_GROUP_KEY)
    k = KeyAgreement("probe")
    return k.kex_scheme, k.prg_scheme


def _masked_steps(card, dev):
    """(a): the weight-and-mask step and the correction on the card against
    the CPU, at the ring's wrap edges and at ResNet-18's size; the card's
    time of each against its bound (each input read once, the output
    written once)."""
    import numpy as np

    edges = np.array([0, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)
    diff = 0
    for wire_dtype, w_max in (("uint8", (2**31 - 1) // 255), ("int8", (2**31 - 1) // 128)):
        info = np.iinfo(wire_dtype)
        q = np.repeat(np.array([info.min, info.max, 0, 1], wire_dtype), 4)
        for w in (0, 1, 7, w_max):
            for m in edges:
                mask = np.tile(edges, 4) + m
                cpu = fedavg.masked_code_kernel(torch.from_numpy(q), w, mask)
                gpu = fedavg.masked_code_kernel(torch.from_numpy(q).to(dev), w, mask)
                diff += int((gpu.cpu() != cpu).sum())
    rng = np.random.default_rng(SEED)
    n = SECAGG_ELEMS
    q = torch.from_numpy(rng.integers(0, 256, n, dtype=np.uint8))
    mask = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    corr = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    acc = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int32))
    w = (2**31 - 1) // (255 * 4)
    cpu_codes = fedavg.masked_code_kernel(q, w, mask)
    q_dev = q.to(dev)
    mask_dev = fedavg._ring_words(mask, dev)
    corr_dev = fedavg._ring_words(corr, dev)
    gpu_codes = fedavg.masked_code_kernel(q_dev, w, mask_dev)
    diff_codes = int((gpu_codes.cpu() != cpu_codes).sum())
    cpu_acc = fedavg.masked_correction_kernel(acc.clone(), corr)
    acc_dev = acc.to(dev)
    fedavg.masked_correction_kernel(acc_dev, corr_dev)
    diff_corr = int((acc_dev.cpu() != cpu_acc).sum())
    if diff or diff_codes or diff_corr:
        raise AssertionError(f"[secagg steps] card != CPU: edges {diff}, codes {diff_codes}, correction {diff_corr}")
    code_ms = _sync_ms(lambda: fedavg.masked_code_kernel(q_dev, w, mask_dev), 10)
    corr_ms = _sync_ms(lambda: fedavg.masked_correction_kernel(acc_dev, corr_dev), 10)
    upload_ms = _sync_ms(lambda: fedavg._ring_words(mask, dev), 3)
    code_bound, _ = _bound(0, n * (1 + 4 + 4), card)
    corr_bound, _ = _bound(0, n * (4 + 4 + 4), card)
    print(f"[secagg steps] card == CPU at the wrap edges (codes ±qabs_max, weights to the headroom bound, "
          f"masks 0, 2^31-1, 2^31, 2^32-1) and at {n} elements: 0 differing elements")
    print(f"[secagg steps] masked_code_kernel {code_ms:.4f} ms (bound {code_bound:.4f} ms, bytes), "
          f"masked_correction_kernel {corr_ms:.4f} ms (bound {corr_bound:.4f} ms, bytes), "
          f"the net mask's upload through pinned staging {upload_ms:.3f} ms, at {n} elements")
    return {"code_ms": code_ms, "code_bound_ms": code_bound, "corr_ms": corr_ms, "corr_bound_ms": corr_bound,
            "upload_ms": upload_ms}


def _robust_on_card(card, dev):
    """(d): tree_median, tree_trimmed_mean(trim=1), krum(num_byzantine=1)
    and clip_by_global_norm over four ResNet-18 contributions (one scaled
    x100) on the card, against the same calls on the CPU."""
    from rayfed_tpu_torch import tree_util
    from rayfed_tpu_torch.fl import dp, robust
    from rayfed_tpu_torch.models import resnet

    cpu = [resnet.init_resnet(torch.Generator().manual_seed(SEED + 40 + i), resnet.resnet18(num_classes=10),
                              device=torch.device("cpu"))[0]
           for i in range(4)]
    cpu[3] = tree_util.tree_map(lambda x: x * 100.0, cpu[3])
    card_trees = [tree_util.tree_map(lambda x: x.to(dev), t) for t in cpu]
    n = sum(x.numel() for x in tree_util.tree_leaves(cpu[0]))
    out = {}
    for name, fn in (("tree_median", robust.tree_median),
                     ("tree_trimmed_mean", lambda ts: robust.tree_trimmed_mean(ts, trim=1)),
                     ("krum", lambda ts: robust.krum(ts, num_byzantine=1))):
        want = _leaf_digest(fn(cpu))["sha256"]
        got = _leaf_digest(tree_util.tree_map(lambda x: x.cpu(), fn(card_trees)))["sha256"]
        if got != want:
            raise AssertionError(f"[robust] {name}: the card's result differs from the CPU's")
        out[name] = _sync_ms(lambda: fn(card_trees), 3, warmup=1)
    pick = robust.krum(card_trees, num_byzantine=1)
    picked = next(i for i, t in enumerate(card_trees) if t is pick)
    if picked == 3:
        raise AssertionError("[robust] krum picked the scaled contribution")
    (cpu_clip, cpu_norm), (gpu_clip, gpu_norm) = dp.clip_by_global_norm(cpu[3], DP_CLIP), \
        dp.clip_by_global_norm(card_trees[3], DP_CLIP)
    norm_rel = abs(float(gpu_norm) - float(cpu_norm)) / float(cpu_norm)
    clip_rel = max(float(((g.cpu() - c).abs() / c.abs().clamp_min(1e-30)).max())
                   for g, c in zip(tree_util.tree_leaves(gpu_clip), tree_util.tree_leaves(cpu_clip)))
    if norm_rel > DP_RTOL or clip_rel > DP_RTOL:
        raise AssertionError(f"[dp] clip on the card vs the CPU: norm rel {norm_rel:.2e}, leaves rel {clip_rel:.2e}")
    out["clip_by_global_norm"] = _sync_ms(lambda: dp.clip_by_global_norm(card_trees[3], DP_CLIP), 3, warmup=1)
    # Bounds: f32 inputs read once and outputs written once (the median and
    # the trimmed mean read four trees and write one, krum reads four and
    # hands back one of them, the clip reads one tree and writes it scaled).
    bounds = {name: _bound(0, n * 4 * trees, card)[0] for name, trees in
              (("tree_median", 5), ("tree_trimmed_mean", 5), ("krum", 4), ("clip_by_global_norm", 2))}
    print(f"[robust] four ResNet-18 contributions ({n} elements each, one x100) on the card == CPU by SHA-256: "
          f"tree_median {out['tree_median']:.3f} ms, tree_trimmed_mean(trim=1) {out['tree_trimmed_mean']:.3f} ms, "
          f"krum(num_byzantine=1) {out['krum']:.3f} ms (picked contribution {picked})")
    print(f"[dp] clip_by_global_norm on the card {out['clip_by_global_norm']:.3f} ms; norm {float(gpu_norm):.6e} "
          f"(rel {norm_rel:.2e} from the CPU's), clipped leaves within rel {clip_rel:.2e} (tolerance {DP_RTOL})")
    print(f"[robust] bounds (bytes, each f32 input read and output written once): "
          f"{json.dumps({k: round(v, 4) for k, v in bounds.items()})} ms")
    out["bound_ms"] = bounds
    return out


def phase_secagg(card, suite, topo, federated):
    """Secure aggregation, DP clipping and the robust reducers on the card:
    the suite, (a) the masked steps card vs CPU, (b) and (c) the masked
    rounds (run in the topology and federated processes, summarized there),
    (d) the robust reducers and the clip."""
    from rayfed_tpu_torch.fl import secagg as sa

    dev = torch.device("cuda", 0)
    print(f"[secagg] suite kex={suite[0]} prg={suite[1]}"
          f"{' (group key set by this script)' if suite[0] == 'nonce' else ''}; this process's SECAGG_STATS "
          f"{json.dumps(sa.SECAGG_STATS)}")
    steps = _masked_steps(card, dev)
    robust_ms = _robust_on_card(card, dev)
    q, r = topo["secagg"], federated["round_secagg"]
    print(f"[secagg] BASELINE #3 masked/plain round walls {q['ratio']:.3f}; Llama-3-8B LoRA masking overhead "
          f"{r['overhead_frac']:.4f} of a round, mask_gen_ms {r['mask_gen_ms']:.2f}")
    return {"steps": steps, "robust_ms": robust_ms, "quorum": q, "llama": r}


# phase_checkpoint: per-party snapshots and resume.  (a) The Llama-3-8B LoRA
# round under FedAC, the streaming hub: in the round session (5) two
# uninterrupted runs of CKPT_ROUNDS rounds, a snapshot every round, which
# must agree on the card; then fresh party processes whose checkpointers hold
# the first run's snapshots up to round CKPT_RESUME resume it and run the
# rest.  (b) BASELINE #3 quorum rounds: four party processes run
# uninterrupted, then the whole cluster crashes at a round boundary (the
# chaos harness), and fresh processes resume from the snapshots with the
# flight recorder armed.
CKPT_ROUNDS, CKPT_RESUME = 4, 2
CKPT_RUNS = ("ckpt_a", "ckpt_a2")
CKPT_ROUND_KW = {"streaming_agg": True, "server_opt": fl.fedac(1.0, 3.0, 0.5)}
CKPT_TIMEOUT_S = 300  # hard limit on each spawn of phase_checkpoint's party processes
CKPT_Q_CHAOS = {"seed": 19, "rules": [{"hook": "round", "match": {"round": CKPT_RESUME}, "op": "crash_party"}]}
CKPT_Q_KW = dict(compress_wire=True, packed_wire=True, quorum=QUORUM_K, round_deadline_s=30.0,
                 coordinator="alice", checkpoint_every=1)
CKPT_TRACE_TOL = 0.25  # trace_report's round wall against the driver's (bench.py's trace_critical_path_agrees)


class _CkptTrainer(_RoundTrainer):
    """A party's trainer of the checkpointed rounds: one LoRA step per round
    from the broadcast adapters with a fresh Adam state, so a restarted
    party trains what an uninterrupted one does (the snapshot holds the
    server's state, not the trainer's)."""

    def train(self, wire_adapters):
        self.opt = None
        return super().train(wire_adapters)


class _RecordingCheckpointer(FedCheckpointer):
    """A FedCheckpointer that records each snapshot's SHA-256 (params and
    server state), save ms, content-cache bytes and size on disk, and each
    restore's SHA-256, ms and source (the content cache or the disk)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.saves, self.restores, self._source = {}, [], None

    def save(self, round_num, state, *, metadata=None):
        t0 = time.perf_counter()
        super().save(round_num, state, metadata=metadata)
        ms = (time.perf_counter() - t0) * 1e3
        path = self._round_dir(round_num)
        self.saves[round_num] = {
            "digest": _leaf_digest(state), "ms": ms, "blob_n": self.load_metadata(round_num).get("blob_n", 0),
            "disk_bytes": sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path)),
        }

    def _restore_from_blob(self, round_num, target, dev):
        got = super()._restore_from_blob(round_num, target, dev)
        self._source = "disk" if got is None else "blob"
        return got

    def restore(self, round_num=None, *, target=None):
        t0 = time.perf_counter()
        got_round, state = super().restore(round_num, target=target)
        ms = (time.perf_counter() - t0) * 1e3
        self.restores.append({"round": got_round, "digest": _leaf_digest(state), "ms": ms, "source": self._source})
        return got_round, state


def _ckpt_round_parts(fed, party, cache, cfg_name, cfg_kw, train_len, device, adapters, ckpt_root):
    """(a)'s uninterrupted runs in the round session, each from ``adapters``
    with its own checkpointer, then a warm restore of its last snapshot
    from this party's content cache."""
    trainers = {p: fed.remote(_CkptTrainer).party(p).remote(cache, cfg_name, cfg_kw, train_len, device, i)
                for i, p in enumerate(FED_PARTIES)}
    digest = fed.remote(_leaf_digest)
    out = {}
    for tag in CKPT_RUNS:
        ckpt = _RecordingCheckpointer(os.path.join(ckpt_root, tag), party)
        fold.fold_fma_.launches = 0
        t0 = time.perf_counter()
        final = fl.run_fedavg_rounds(trainers, adapters, rounds=CKPT_ROUNDS, compress_wire=True, packed_wire=True,
                                     checkpointer=ckpt, checkpoint_every=1, **CKPT_ROUND_KW)
        _sync(device)
        wall_s = time.perf_counter() - t0
        fold_launches = fold.fold_fma_.launches
        target = {"params": final,
                  "server_state": CKPT_ROUND_KW["server_opt"].init(fl.pack_tree(final, torch.float32).buf, device)}
        ckpt.restore(CKPT_ROUNDS, target=target)
        out[tag] = {
            "wall_s": wall_s, "fold_launches": fold_launches, "saves": ckpt.saves, "restores": ckpt.restores,
            "dir": ckpt._dir,
            "digests": dict(zip(FED_PARTIES, fed.get([digest.party(p).remote(final) for p in FED_PARTIES]))),
            "trainers": dict(zip(FED_PARTIES, fed.get([trainers[p].report.remote() for p in FED_PARTIES]))),
        }
    return out


def _ckpt_resume_party(party, ports, cfg_name, cfg_kw, train_len, ckpt_dir, device, out):
    """(a)'s resumed run in a fresh party process: the checkpointer holds the
    first run's snapshots up to round CKPT_RESUME; the rounds after it run
    here."""
    import rayfed_tpu_torch as fed

    try:
        cluster = {p: {"address": f"127.0.0.1:{port}"} for p, port in zip(FED_PARTIES, ports)}
        dev = fed.init(address="local", cluster=cluster, party=party, device=device, **FED_INIT).transport.device
        cache = _ModelCache()
        trainers = {p: fed.remote(_CkptTrainer).party(p).remote(cache, cfg_name, cfg_kw, train_len, dev, i)
                    for i, p in enumerate(FED_PARTIES)}
        start = fed.get(trainers["alice"].initial.remote())  # the snapshot's params take its place
        ckpt = _RecordingCheckpointer(ckpt_dir, party)
        seen = []
        fold.fold_fma_.launches = 0
        t0 = time.perf_counter()
        final = fl.run_fedavg_rounds(trainers, start, rounds=CKPT_ROUNDS, compress_wire=True, packed_wire=True,
                                     checkpointer=ckpt, checkpoint_every=1,
                                     on_round=lambda r, _p: seen.append(r), **CKPT_ROUND_KW)
        _sync(dev)
        report = {"party": party, "wall_s": time.perf_counter() - t0, "rounds": seen,
                  "fold_launches": fold.fold_fma_.launches, "saves": ckpt.saves, "restores": ckpt.restores,
                  "final": _leaf_digest(final),
                  "trainer": fed.get([trainers[p].report.remote() for p in FED_PARTIES])[FED_PARTIES.index(party)]}
        fed.shutdown()
        out.put(report)
    except BaseException:
        out.put({"party": party, "error": traceback.format_exc()})
        raise


def _deterministic():
    """Deterministic convolutions and GEMMs on the card: runs that must give
    the same bytes train the same bytes from the same inputs."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)


def _file_barrier(root, name, party, parties, timeout_s=120):
    """Wait until every party has reached ``name`` (a file each under ``root``)."""
    open(os.path.join(root, f"{name}.{party}"), "w").close()
    deadline = time.monotonic() + timeout_s
    while not all(os.path.exists(os.path.join(root, f"{name}.{p}")) for p in parties):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{name}: parties never arrived")
        time.sleep(0.05)


def _ckpt_quorum_party(party, ports, ckpt_root, stage, device, out):
    """(b)'s party process.  ``stage="first"``: the uninterrupted quorum run,
    then the same run from a fresh runtime under CKPT_Q_CHAOS, which crashes
    every party at round CKPT_RESUME (each waits for the others, so all have
    the round's snapshot; then it exits with CRASH_EXIT).  ``stage=
    "resume"``: a fresh runtime, the flight recorder armed, resumes the
    crashed run from its snapshots; alice merges every party's trace."""
    _deterministic()
    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch import chaos
    from rayfed_tpu_torch.models import resnet

    def run(tag, ckpt, log, **init_kw):
        cluster = {p: {"address": f"127.0.0.1:{port}"} for p, port in zip(TOPO_PARTIES, ports[tag])}
        dev = fed.init(address="local", cluster=cluster, party=party, device=device, **QUORUM_INIT,
                       **init_kw).transport.device
        params0 = resnet.init_resnet(torch.Generator().manual_seed(SEED), resnet.resnet18(num_classes=10),
                                     device=dev)
        trainers = {p: fed.remote(_ResNetTrainer).party(p).remote(SEED + 1 + i, dev)
                    for i, p in enumerate(TOPO_PARTIES)}
        fold.fold_fma_.launches = 0
        _zero_counts()
        final = fl.run_fedavg_rounds(trainers, params0, rounds=CKPT_ROUNDS, round_log=log, checkpointer=ckpt,
                                     **CKPT_Q_KW)
        return final

    def summary(ckpt, log, final=None):
        return {"saves": ckpt.saves, "restores": ckpt.restores, "log": log, "fold_launches": fold.fold_fma_.launches,
                "flash_launches": _counts(), "digest": None if final is None else _leaf_digest(final)}

    try:
        if stage == "first":
            ckpt, log = _RecordingCheckpointer(os.path.join(ckpt_root, "q_u"), party), []
            final = run("uninterrupted", ckpt, log)
            fed.shutdown()
            out.put({"party": party, "progress": True, "uninterrupted": summary(ckpt, log, final)})
            chaos.install(CKPT_Q_CHAOS)
            ckpt, log = _RecordingCheckpointer(os.path.join(ckpt_root, "q_a"), party), []
            try:
                run("crashed", ckpt, log)
                raise AssertionError("the chaos schedule never crashed this party")
            except chaos.ChaosPartyCrash:
                _file_barrier(ckpt_root, "q_down", party, TOPO_PARTIES)
                out.put({"party": party, "crashed": True, **summary(ckpt, log)})
                out.close()
                out.join_thread()
                os._exit(CRASH_EXIT)
        from rayfed_tpu_torch import telemetry

        ckpt, log = _RecordingCheckpointer(os.path.join(ckpt_root, "q_a"), party), []
        final = run("resumed", ckpt, log, trace=True)
        report = {"party": party, **summary(ckpt, log, final)}
        barrier = fed.remote(lambda: 0)
        fed.get([barrier.party(p).remote() for p in TOPO_PARTIES])
        if party == "alice":
            from tool.trace_report import round_report

            trace = fed.trace_collect(timeout=60)
            records = trace["records"]
            perfetto = telemetry.to_trace_events(records, trace["clock_offsets"])
            rep = round_report(records, tolerance=CKPT_TRACE_TOL)
            report["trace"] = {
                "records": len(records), "missing": trace["missing"],
                "events": len(perfetto.get("traceEvents", [])),
                "parties_with_spans": sorted({str(r.get("party")) for r in records
                                              if r.get("phase") != "driver.round"}),
                "phases": sorted({str(r.get("phase")) for r in records}),
                "ckpt": {ph: sum(r.get("phase") == ph for r in records) for ph in ("ckpt.save", "ckpt.restore")},
                "rounds": {int(k): {"wall_s": v["wall_s"], "driver_wall_s": v["driver_wall_s"],
                                    "wall_agrees": v["wall_agrees"]} for k, v in rep.items()},
            }
        fed.get([barrier.party(p).remote() for p in TOPO_PARTIES])
        fed.shutdown()
        out.put(report)
    except BaseException:
        out.put({"party": party, "error": traceback.format_exc()})
        raise


def _ckpt_llama_summary(federated, resumed, want):
    """(a)'s checks and prints: the two uninterrupted runs agree; the resumed
    run restored round CKPT_RESUME's snapshot byte for byte, stepped through
    the three kernels (``want`` launches per step) and ends where the
    uninterrupted run ended (adapters and FedAC state), at both parties."""
    a, a2 = (federated["checkpoint"][t] for t in CKPT_RUNS)
    launches = {k: 0 for k in want}
    fold_launches = 0
    for tag, run in zip(CKPT_RUNS, (a, a2)):
        for p in FED_PARTIES:
            r = run[p]
            if r["digests"]["alice"] != r["digests"]["bob"] or r["digests"] != run["alice"]["digests"]:
                raise AssertionError(f"[ckpt] {tag}: the parties' final adapters differ")
            steps = r["trainers"][p]["steps"]
            if len(steps) != CKPT_ROUNDS or any(s["launches"] != want for s in steps):
                raise AssertionError(f"[ckpt] {tag}: {p}'s steps launched {[s['launches'] for s in steps]}")
            for s in steps:
                for k in launches:
                    launches[k] += s["launches"][k]
            fold_launches += r["fold_launches"]
            if sorted(r["saves"]) != list(range(1, CKPT_ROUNDS + 1)):
                raise AssertionError(f"[ckpt] {tag}: {p} saved rounds {sorted(r['saves'])}")
    for p in FED_PARTIES:
        if any(a[p]["saves"][n]["digest"] != a2[p]["saves"][n]["digest"] for n in a[p]["saves"]):
            raise AssertionError(f"[ckpt] two uninterrupted runs disagree on the card at {p}: "
                                 f"{[(n, a[p]['saves'][n]['digest']['sha256'][:16], a2[p]['saves'][n]['digest']['sha256'][:16]) for n in a[p]['saves']]}")
    if any(want.values()) and not a["alice"]["fold_launches"]:
        raise AssertionError("[ckpt] alice's folds never launched the fold kernel")
    for p in FED_PARTIES:
        b = resumed[p]
        rest = b["restores"]
        if b["rounds"] != list(range(CKPT_RESUME, CKPT_ROUNDS)) or len(rest) != 1 or rest[0]["round"] != CKPT_RESUME:
            raise AssertionError(f"[ckpt] resumed {p}: rounds {b['rounds']}, restores {rest}")
        if rest[0]["digest"] != a[p]["saves"][CKPT_RESUME]["digest"]:
            raise AssertionError(f"[ckpt] resumed {p}: the restored round-{CKPT_RESUME} state differs from the saved "
                                 f"one: {rest[0]['digest']} vs {a[p]['saves'][CKPT_RESUME]['digest']}")
        if b["final"]["sha256"] != a[p]["digests"][p]["sha256"]:
            raise AssertionError(f"[ckpt] resumed {p}: final adapters {b['final']['sha256'][:16]} != the uninterrupted "
                                 f"run's {a[p]['digests'][p]['sha256'][:16]}")
        if b["saves"][CKPT_ROUNDS]["digest"] != a[p]["saves"][CKPT_ROUNDS]["digest"]:
            raise AssertionError(f"[ckpt] resumed {p}: the round-{CKPT_ROUNDS} snapshot (adapters and FedAC state) "
                                 f"differs from the uninterrupted run's")
        steps = b["trainer"]["steps"]
        if len(steps) != CKPT_ROUNDS - CKPT_RESUME or any(s["launches"] != want for s in steps):
            raise AssertionError(f"[ckpt] resumed {p}: steps launched {[s['launches'] for s in steps]}")
        for s in steps:
            for k in launches:
                launches[k] += s["launches"][k]
        fold_launches += b["fold_launches"]
    sa = a["alice"]["saves"]
    warm = a["alice"]["restores"][0]
    cold = resumed["alice"]["restores"][0]
    if (warm["source"], cold["source"]) != ("blob", "disk"):
        raise AssertionError(f"[ckpt] restore sources {warm['source']}, {cold['source']}: want blob, disk")
    print(f"[ckpt] Llama-3-8B LoRA, FedAC, {CKPT_ROUNDS} rounds, a snapshot per round and party: two uninterrupted "
          f"runs equal (SHA-256 of every snapshot); resumed from round {CKPT_RESUME} in fresh processes: the restored "
          f"state equal to the saved one, the final adapters ({a['alice']['digests']['alice']['sha256'][:16]}) and "
          f"FedAC state equal to the uninterrupted run's at both parties")
    print(f"[ckpt] alice's ckpt.save per round {[round(sa[n]['ms'], 1) for n in sorted(sa)]} ms, "
          f"{sa[CKPT_ROUNDS]['blob_n'] / 1e6:.2f} MB content-cache bytes, {sa[CKPT_ROUNDS]['disk_bytes'] / 1e6:.2f} MB "
          f"on disk per snapshot; ckpt.restore {warm['ms']:.1f} ms from the content cache (blob, round "
          f"{warm['round']}), {cold['ms']:.1f} ms from disk (a fresh process, round {cold['round']})")
    print(f"[ckpt] walls: uninterrupted {a['alice']['wall_s']:.2f} / {a2['alice']['wall_s']:.2f} s for {CKPT_ROUNDS} "
          f"rounds; resumed {resumed['alice']['wall_s']:.2f} s for {CKPT_ROUNDS - CKPT_RESUME}, the restore included; "
          f"flash launches over every step {launches}, fold_fma launches {fold_launches}")
    return {"launches": launches, "fold_launches": fold_launches, "save_ms": [sa[n]["ms"] for n in sorted(sa)],
            "blob_bytes": sa[CKPT_ROUNDS]["blob_n"], "disk_bytes": sa[CKPT_ROUNDS]["disk_bytes"],
            "restore_ms": {"blob": warm["ms"], "disk": cold["ms"]}}


def _ckpt_quorum_summary(first, resumed):
    """(b)'s checks and prints: every party crashed at round CKPT_RESUME with
    its snapshot; the resumed run's member log spans the restart and its
    final params equal the uninterrupted run's at every party; no flash
    launch; the merged trace covers all four parties, carries the
    checkpoint spans, exports to Perfetto and its round walls agree with
    the drivers'."""
    unint = {p: r["progress"][0]["uninterrupted"] for p, r in first.items()}
    u = {unint[p]["digest"]["sha256"] for p in TOPO_PARTIES}
    fin = {resumed[p]["digest"]["sha256"] for p in TOPO_PARTIES}
    if len(u) != 1 or fin != u:
        raise AssertionError(f"[ckpt quorum] finals: uninterrupted {u}, resumed {fin}")
    for p in TOPO_PARTIES:
        crashed, res = first[p], resumed[p]
        if not crashed.get("crashed") or max(crashed["saves"]) != CKPT_RESUME:
            raise AssertionError(f"[ckpt quorum] {p} crashed {crashed.get('crashed')} with snapshots "
                                 f"{sorted(crashed['saves'])}")
        log = res["log"]
        if [e["round"] for e in log] != list(range(CKPT_ROUNDS)) or log[:CKPT_RESUME] != crashed["log"]:
            raise AssertionError(f"[ckpt quorum] {p}'s resumed log {log} does not span the restart")
        if res["restores"][0]["digest"] != crashed["saves"][CKPT_RESUME]["digest"]:
            raise AssertionError(f"[ckpt quorum] {p}: the restored state differs from the saved one")
        if any(res["flash_launches"].values()) or any(unint[p]["flash_launches"].values()):
            raise AssertionError(f"[ckpt quorum] {p}: flash launches on ResNet-18")
    t = resumed["alice"]["trace"]
    rounds = {r: v for r, v in t["rounds"].items() if v["driver_wall_s"] is not None}
    print(f"[ckpt quorum] BASELINE #3, {len(TOPO_PARTIES)} parties, quorum {QUORUM_K}: uninterrupted and resumed "
          f"finals equal at every party ({next(iter(u))[:16]}); every party crashed at round {CKPT_RESUME} with its "
          f"snapshot, the resumed member log spans the restart")
    sa = resumed["alice"]["saves"]
    print(f"[ckpt quorum] alice's ckpt.save {[round(sa[n]['ms'], 1) for n in sorted(sa)]} ms, "
          f"{sa[max(sa)]['disk_bytes'] / 1e6:.2f} MB on disk per snapshot; ckpt.restore "
          f"{resumed['alice']['restores'][0]['ms']:.1f} ms ({resumed['alice']['restores'][0]['source']})")
    print(f"[ckpt quorum] merged trace: {t['records']} records, {t['events']} Perfetto events, spans from "
          f"{t['parties_with_spans']}, ckpt spans {t['ckpt']}, missing {t['missing']}; per round trace wall vs "
          f"driver wall {json.dumps({r: [round(v['wall_s'], 4), round(v['driver_wall_s'], 4)] for r, v in rounds.items()})} s")
    bad = [r for r, v in rounds.items() if not v["wall_agrees"]]
    if (set(t["parties_with_spans"]) != set(TOPO_PARTIES) or not t["events"] or not t["ckpt"]["ckpt.save"]
            or not t["ckpt"]["ckpt.restore"] or t["missing"] or sorted(rounds) != list(range(CKPT_RESUME, CKPT_ROUNDS))
            or bad):
        raise AssertionError(f"[ckpt quorum] trace check failed: rounds disagreeing {bad}, {t}")
    fold_launches = sum(unint[p]["fold_launches"] + resumed[p]["fold_launches"] for p in TOPO_PARTIES)
    flash = {k: sum(unint[p]["flash_launches"][k] + resumed[p]["flash_launches"][k] for p in TOPO_PARTIES)
             for k in ("fwd", "bwd_dq", "bwd_dkv")}
    return {"fold_launches": fold_launches, "flash_launches": flash, "trace_rounds": rounds,
            "save_ms": [sa[n]["ms"] for n in sorted(sa)], "disk_bytes": sa[max(sa)]["disk_bytes"]}


def phase_checkpoint(federated, ckpt_root, cfg_name="llama3_8b", cfg_kw=None, train_len=None, device=None):
    """Checkpoint and resume on the card: (a) the Llama-3-8B LoRA rounds'
    resumed run in fresh party processes against the round session's
    uninterrupted ones; (b) BASELINE #3's crashed and resumed quorum run,
    with its merged trace."""
    cfg_kw = dict(param_dtype=torch.bfloat16, remat=True) if cfg_kw is None else cfg_kw
    train_len = TRAIN_LEN if train_len is None else train_len
    cfg = getattr(llama, cfg_name)(**cfg_kw)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    resumed_dir = os.path.join(ckpt_root, "ckpt_b")
    for p in FED_PARTIES:  # a fresh checkpointer directory holding the first run's snapshots to CKPT_RESUME
        src = federated["checkpoint"][CKPT_RUNS[0]][p]["dir"]
        for name in os.listdir(src):
            m = re.fullmatch(r"round_(\d+)", name)
            if m and int(m.group(1)) <= CKPT_RESUME:
                shutil.copytree(os.path.join(src, name), os.path.join(resumed_dir, p, name))
    resumed = _spawn_parties(_ckpt_resume_party, (_free_ports(len(FED_PARTIES)), cfg_name, cfg_kw, train_len,
                                                  resumed_dir, device), CKPT_TIMEOUT_S)
    # The kernels launch on the card only (a CPU rehearsal runs their plain versions).
    on_card = device is None or torch.device(device).type == "cuda"
    want = _lora_step_want(cfg.num_layers, cfg.remat)
    llama_out = _ckpt_llama_summary(federated, resumed, {k: v if on_card else 0 for k, v in want.items()})
    ports = {k: _free_ports(len(TOPO_PARTIES)) for k in ("uninterrupted", "crashed", "resumed")}
    first = _spawn_parties(_ckpt_quorum_party, (ports, ckpt_root, "first", device), CKPT_TIMEOUT_S,
                           parties=TOPO_PARTIES, exit_codes={p: CRASH_EXIT for p in TOPO_PARTIES})
    resumed_q = _spawn_parties(_ckpt_quorum_party, (ports, ckpt_root, "resume", device), CKPT_TIMEOUT_S,
                               parties=TOPO_PARTIES)
    quorum_out = _ckpt_quorum_summary(first, resumed_q)
    return {"llama": llama_out, "quorum": quorum_out}


# ---------------------------------------------------------------------------
# phase_parallel: party-local parallelism (a world of ranks on the one card)
# ---------------------------------------------------------------------------

# The card's sizes and a CPU rehearsal's: (1) the ops at Llama-3-8B's
# attention shape over 4 ranks; (2) Llama-3-8B at full width, cut to 8 layers
# to keep the script in its time limit, under sp=2 (prefill and one LoRA step
# through the zigzag ring); (3) TP/FSDP on a {fsdp: 2, tp: 2} mesh at
# llama3_8b() width, 2 layers; (4) one MoE layer at
# Switch Transformer base-128's widths (d_model 768, d_ff 3072, 128 experts,
# top-1, capacity factor 1.25; the JAX layer's GELU) with ep=4.
PAR_SIZES = {
    "cuda": dict(shape=(1, 16384, 32, 128), dtype=torch.bfloat16, llama="llama3_8b",
                 llama_kw=dict(param_dtype=torch.bfloat16), sp_layers=8, prefill_len=8192, train_len=4096,
                 tp_len=1024, moe=dict(num_experts=128, top_k=1, capacity_factor=1.25, d_model=768,
                                       d_ff=3072), moe_batch=8, moe_len=512),
    "cpu": dict(shape=(1, 64, 4, 16), dtype=torch.bfloat16, llama="llama_tiny", llama_kw={}, sp_layers=2,
                prefill_len=64, train_len=32, tp_len=16,
                moe=dict(num_experts=8, top_k=1, capacity_factor=1.25, d_model=16, d_ff=32),
                moe_batch=2, moe_len=16),
}
PAR_RANKS, PAR_SP = 4, 2
PAR_TP_LAYERS = 2
PAR_TOL = 3e-2  # the reference's bf16 tolerance (tests/test_ops_attention.py:54)
# At T = 16384 a typical |o| is ~1e-2, under PAR_TOL, so each output row is
# also held to its own scale: ||o_row − ref_row|| ≤ PAR_ROW_TOL·||ref_row||
# over the head dim.  Both outputs are rounded to bf16 (2^-9 relative at
# most), so a right merge differs by a few 1e-3 of the row; a dropped block
# or a wrong lse weight moves a row by a large part of itself.
PAR_ROW_TOL = 1e-2
MOE_TOL = 1e-5  # the reference's f32 tolerance (tests/test_moe.py)
PAR_TIMEOUT_S = 420  # hard limit on each world's rank processes
PAR_PATHS = ("sp_ops", "sp_llama_serve", "sp_llama_train", "tp_fsdp")  # launches_by_path keys
# The ops of part (1): each builder's keywords; "ulysses" runs flash_attention inside.
PAR_OPS = (("ring_causal", dict(causal=True, use_flash=True)),
           ("ring_full", dict(causal=False, use_flash=True)),
           ("zigzag", dict(causal=True, use_flash=True, layout="zigzag")),
           ("ulysses", dict(causal=True)))


def par_launches(op, rank, n):
    """Each of the three kernels' launches per rank in one forward and
    backward of a part-(1) op (PERF.md): the causal ring skips the blocks its
    mask hides (1 + rank), the full ring runs every step (n), the zigzag ring
    3 at step 0 and 2 a later step (2n + 1), Ulysses one call (1)."""
    return {"ring_causal": 1 + rank, "ring_full": n, "zigzag": 2 * n + 1, "ulysses": 1}[op]


def _par_zero():
    """Every kernel's count to 0, the three flash kernels' and fold_fma's."""
    _zero_counts()
    fold.fold_fma_.launches = 0


def _par_sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _par_peak_gb(dev):
    return torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0


def _digest(t):
    return hashlib.sha256(t.detach().float().cpu().numpy().tobytes()).hexdigest()[:16]


def _row_rel_err(o, ref):
    """The largest ||o_row − ref_row|| / ||ref_row|| over the rows of the last dim."""
    o, ref = o.float(), ref.float()
    return float(((o - ref).norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)).max())


def _grad_gap(g, ref):
    """The largest |g − ref| over 3e-2·max|ref| + 3e-2·|ref| (≤ 1 passes)."""
    g, ref = g.float(), ref.float()
    bound = PAR_TOL * ref.abs().max() + PAR_TOL * ref.abs()
    return float(((g - ref).abs() / bound).max())


def _par_op(name, kw, mesh):
    from rayfed_tpu_torch.ops import make_ring_attention, make_ulysses_attention

    if name == "ulysses":
        return make_ulysses_attention(mesh, "sp", attn_fn=flash_attention, **kw)
    return make_ring_attention(mesh, "sp", **kw)


def _par_ops_part(rank, dev, size):
    """Part (1): each op forward and backward on the same global bf16
    tensors, against one-card flash on rank 0; then one ring step's kernel
    (rank 0 alone) against one rotation of its K/V block (every rank)."""
    import torch.distributed as dist

    from rayfed_tpu_torch.ops.ring_attention import _merge_partial
    from rayfed_tpu_torch.parallel import collectives as coll
    from rayfed_tpu_torch.parallel.mesh import create_mesh

    mesh = create_mesh({"sp": PAR_RANKS}, device=dev.type)
    group = mesh.get_group("sp")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    qg, kg, vg, dout = (torch.randn(size["shape"], generator=gen, device=dev).to(size["dtype"])
                        for _ in range(4))
    refs, out = {}, {}
    # One untimed forward and backward first: the kernels' libraries load and
    # the pinned host buffers are allocated on first use.
    warm = [x.detach().requires_grad_(True) for x in (qg, kg, vg)]
    torch.autograd.grad(_par_op(*PAR_OPS[1], mesh)(*warm), warm, dout)
    del warm
    for name, kw in PAR_OPS:
        fn = _par_op(name, kw, mesh)
        q, k, v = (x.detach().requires_grad_(True) for x in (qg, kg, vg))
        _par_zero()
        coll.STAGING.reset()
        dist.barrier()
        _par_sync(dev)
        t0 = time.perf_counter()
        o = fn(q, k, v)
        _par_sync(dev)
        t1 = time.perf_counter()
        grads = torch.autograd.grad(o, (q, k, v), dout)
        _par_sync(dev)
        rec = {"fwd_ms": (t1 - t0) * 1e3, "bwd_ms": (time.perf_counter() - t1) * 1e3,
               "launches": _counts(), "fold_launches": fold.fold_fma_.launches,
               "staged_mb": coll.STAGING.bytes / 1e6, "staged_ms": coll.STAGING.ms,
               "digest": [_digest(x) for x in (o, *grads)], "finite": bool(torch.isfinite(o).all())}
        dist.barrier()
        if rank == 0:
            causal = kw["causal"]
            if causal not in refs:
                rq, rk, rv = (x.detach().requires_grad_(True) for x in (qg, kg, vg))
                ro = flash_attention(rq, rk, rv, causal=causal)
                refs[causal] = (ro.detach(), torch.autograd.grad(ro, (rq, rk, rv), dout))
            ro, rgrads = refs[causal]
            o = o.detach()
            rec["max_abs_err"] = float((o.float() - ro.float()).abs().max())
            rec["row_rel_err"] = _row_rel_err(o, ro)
            rec["out_ok"] = (bool(torch.allclose(o.float(), ro.float(), atol=PAR_TOL, rtol=PAR_TOL))
                             and rec["row_rel_err"] <= PAR_ROW_TOL)
            rec["grad_gap"] = max(_grad_gap(g, r) for g, r in zip(grads, rgrads))
        out[name] = rec
        del o, grads, q, k, v
    del refs
    # One ring step: the kernel on one resident block (rank 0 alone; a full
    # ring's block, and a zigzag step's two half blocks), then one rotation
    # of K/V (all ranks, the ring's own ppermute).
    b, t, h, d = size["shape"]
    tl = t // PAR_RANKS
    blk = [torch.randn((b * h, tl, d), generator=gen, device=dev).to(size["dtype"]) for _ in range(3)]
    half = [x[:, : tl // 2].contiguous() for x in blk]
    step = {}
    dist.barrier()
    if rank == 0 and dev.type == "cuda":
        scale = d ** -0.5
        step["kernel_ms"] = _sync_ms(lambda: _flash_forward(*blk, scale=scale, causal=False,
                                                            out_dtype=torch.float32), 10)
        step["zigzag_kernel_ms"] = 2 * _sync_ms(lambda: _flash_forward(*half, scale=scale, causal=False,
                                                                         out_dtype=torch.float32), 10)
        o_acc, lse_acc = _flash_forward(*blk, scale=scale, causal=False, out_dtype=torch.float32)
        step["merge_ms"] = _sync_ms(lambda: _merge_partial(o_acc, lse_acc, o_acc, lse_acc), 10)
        step["merge_bytes"] = 3 * o_acc.numel() * 4 + 3 * lse_acc.numel() * 4
        del o_acc, lse_acc
    dist.barrier()
    coll.STAGING.reset()
    rot_ms = []
    for _ in range(3):
        dist.barrier()
        t0 = time.perf_counter()
        coll.ppermute_start(blk[1:], group).wait()
        _par_sync(dev)
        rot_ms.append((time.perf_counter() - t0) * 1e3)
    step.update(rotation_ms=min(rot_ms), rotation_mb=2 * blk[1].numel() * blk[1].element_size() / 1e6,
                staged_mb=coll.STAGING.bytes / 3 / 1e6, staged_ms=coll.STAGING.ms / 3)
    return {"ops": out, "step": step}


def _par_tp_part(rank, dev, size):
    """Part (3): the {fsdp: 2, tp: 2} strategy's forward of a 2-layer
    Llama-3-8B-width model under llama.PARTITION_RULES (attention heads over
    tp through the flash kernel), against the unsharded forward on rank 0."""
    import torch.distributed as dist

    from rayfed_tpu_torch.parallel.mesh import create_mesh
    from rayfed_tpu_torch.parallel.sharding import ShardingStrategy, sharded_attn_fn

    cfg = getattr(llama, size["llama"])(num_layers=PAR_TP_LAYERS, **size["llama_kw"])
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    params = llama.init_llama(cfg, gen, device=dev)
    ids = torch.randint(0, cfg.vocab_size, (1, size["tp_len"]), generator=gen, device=dev)
    mesh = create_mesh({"fsdp": 2, "tp": 2}, device=dev.type)
    strat = ShardingStrategy(mesh=mesh, param_rules=llama.PARTITION_RULES)
    sharded = strat.shard_params(params)
    local_gb = sum(x.to_local().numel() * x.to_local().element_size()
                   for x in torch.utils._pytree.tree_leaves(sharded)) / 1e9
    attn = sharded_attn_fn(mesh, flash_attention)
    step = strat.jit_step(lambda p, i: llama.apply_llama(p, i, cfg, attn_fn=attn))
    step(sharded, ids).full_tensor()  # untimed: DTensor's first dispatch of each op
    _par_zero()
    dist.barrier()
    _par_sync(dev)
    t0 = time.perf_counter()
    logits = step(sharded, ids).full_tensor()
    _par_sync(dev)
    rec = {"ms": (time.perf_counter() - t0) * 1e3, "launches": _counts(),
           "fold_launches": fold.fold_fma_.launches, "local_param_gb": local_gb,
           "digest": _digest(logits), "finite": bool(torch.isfinite(logits).all())}
    dist.barrier()
    if rank == 0:
        ref = llama.apply_llama(params, ids, cfg, attn_fn=flash_attention)
        rec["gap"] = float((logits - ref).abs().max())
        rec["span"] = float(ref.abs().max())
    return rec


def _par_moe_part(rank, dev, size):
    """Part (4): the MoE layer with its experts over ep=4 (Shard(0) by
    moe.PARTITION_RULES) against the one-rank layer on rank 0."""
    import torch.distributed as dist

    from rayfed_tpu_torch.models import moe
    from rayfed_tpu_torch.parallel.mesh import create_mesh
    from rayfed_tpu_torch.parallel.sharding import ShardingStrategy

    cfg = moe.MoeConfig(**size["moe"])
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    params = moe.init_moe(cfg, gen, device=dev)
    x = torch.randn((size["moe_batch"], size["moe_len"], cfg.d_model), generator=gen, device=dev)
    mesh = create_mesh({"ep": PAR_RANKS}, device=dev.type)
    sharded = ShardingStrategy(mesh=mesh, param_rules=moe.PARTITION_RULES).shard_params(params)
    local = {"gate": sharded["gate"].to_local(), "w_in": sharded["w_in"], "w_out": sharded["w_out"]}
    ep = mesh.get_group("ep")
    moe.apply_moe(local, x, cfg, ep_group=ep)  # untimed: the first call of each kernel
    moe.apply_moe(params, x, cfg)
    dist.barrier()
    _par_sync(dev)
    t0 = time.perf_counter()
    out, aux = moe.apply_moe(local, x, cfg, return_aux=True, ep_group=ep)
    _par_sync(dev)
    rec = {"ms": (time.perf_counter() - t0) * 1e3, "local_experts": sharded["w_in"].to_local().shape[0],
           "digest": _digest(out), "dropped": float(aux["dropped_fraction"])}
    dist.barrier()
    if rank == 0:
        _par_sync(dev)
        t0 = time.perf_counter()
        ref, ref_aux = moe.apply_moe(params, x, cfg, return_aux=True)
        _par_sync(dev)
        rec["one_rank_ms"] = (time.perf_counter() - t0) * 1e3
        rec["max_abs_err"] = float((out - ref).abs().max())
        rec["ok"] = bool(torch.allclose(out, ref, atol=MOE_TOL, rtol=MOE_TOL))
        rec["aux_ok"] = abs(float(aux["aux_loss"]) - float(ref_aux["aux_loss"])) <= MOE_TOL * float(ref_aux["aux_loss"])
    return rec


def _par_world_ops(rank, dev, size):
    """World A (4 ranks): parts (1), (3) and (4), one after another."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rep = {"backend": dist.get_backend()}
    for part, fn in (("attn", _par_ops_part), ("tp", _par_tp_part), ("moe", _par_moe_part)):
        t0 = time.perf_counter()
        rep[part] = fn(rank, dev, size)
        rep[f"{part}_wall_s"] = time.perf_counter() - t0
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    rep["peak_gb"] = _par_peak_gb(dev)
    return rep


def _par_world_llama(rank, dev, size):
    """World B (2 ranks, sp=2): Llama-3-8B at full width and ``sp_layers``
    layers, a bf16 replica on each rank; the zigzag ring's prefill and one
    LoRA step against one-card flash on rank 0."""
    import torch.distributed as dist

    from rayfed_tpu_torch.ops import make_ring_attention
    from rayfed_tpu_torch.parallel import collectives as coll
    from rayfed_tpu_torch.parallel.mesh import create_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cfg = getattr(llama, size["llama"])(num_layers=size["sp_layers"], **size["llama_kw"])
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = llama.init_llama(cfg, gen, device=dev)
    _par_sync(dev)
    rep = {"backend": dist.get_backend(), "init_s": time.perf_counter() - t0}
    mesh = create_mesh({"sp": PAR_SP}, device=dev.type)
    ring = make_ring_attention(mesh, "sp", causal=True, use_flash=True, layout="zigzag")

    # Serving: prefill of one 8192-token prompt.
    prompt = torch.randint(0, cfg.vocab_size, (1, size["prefill_len"]), generator=gen, device=dev)
    _par_zero()
    coll.STAGING.reset()
    dist.barrier()
    t0 = time.perf_counter()
    cache, logits = llama.prefill(params, cfg, prompt, size["prefill_len"], attn_fn=ring)
    _par_sync(dev)
    serve = {"ms": (time.perf_counter() - t0) * 1e3, "launches": _counts(),
             "fold_launches": fold.fold_fma_.launches, "staged_mb": coll.STAGING.bytes / 1e6,
             "digest": _digest(logits), "finite": bool(torch.isfinite(logits).all()),
             "cache_gb": sum(t.numel() * t.element_size() for t in cache.values()) / 1e9}
    dist.barrier()
    if rank == 0:
        ref_cache, ref_logits = llama.prefill(params, cfg, prompt, size["prefill_len"], attn_fn=flash_attention)
        serve["gap"] = float((logits - ref_logits).abs().max())
        serve["span"] = float(ref_logits.abs().max())
        k_ring, k_ref = cache["k"][-1].float(), ref_cache["k"][-1].float()
        serve["cache_gap"] = float((k_ring - k_ref).abs().max())
        serve["cache_span"] = float(k_ref.abs().max())
        del ref_cache, ref_logits, k_ring, k_ref
    del cache, logits
    rep["serve"] = serve
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # Training: one LoRA step (rank 16 on w[qv], remat) through the ring's backward.
    tcfg = dataclasses.replace(cfg, remat=True)
    adapters = lora.init_lora(params, lora.LoraConfig(rank=LORA_RANK, targets=(r"w[qv]$",)), gen, device=dev)
    for entry in adapters["layers"].values():  # B != 0, or dL/dA is exactly 0
        entry["b"] = 0.01 * torch.randn(entry["b"].shape, generator=gen, device=dev)
    ids = torch.randint(0, cfg.vocab_size, (1, size["train_len"]), generator=gen, device=dev)
    _par_zero()
    coll.STAGING.reset()
    dist.barrier()
    t0 = time.perf_counter()
    loss, grads = llama._value_and_grad(llama._lora_loss(tcfg, ring), adapters, params, ids)
    new_adapters, _ = llama._adam_update(adapters, grads, llama.init_adam(adapters), TRAIN_LR, 0.9, 0.999, 1e-8)
    _par_sync(dev)
    train = {"ms": (time.perf_counter() - t0) * 1e3, "launches": _counts(),
             "fold_launches": fold.fold_fma_.launches, "staged_mb": coll.STAGING.bytes / 1e6,
             "loss": float(loss), "digest": _digest(grads["layers"]["wq"]["a"]),
             "finite": all(bool(torch.isfinite(x).all()) for x in torch.utils._pytree.tree_leaves(new_adapters))}
    del new_adapters
    dist.barrier()
    if rank == 0:
        ref_loss, ref_grads = llama._value_and_grad(llama._lora_loss(tcfg, flash_attention), adapters, params, ids)
        train["ref_loss"] = float(ref_loss)
        train["grad_gaps"] = {
            f"{target}.{leaf}": (float((grads["layers"][target][leaf] - ref_grads["layers"][target][leaf]).abs().max()),
                                 float(ref_grads["layers"][target][leaf].abs().max()))
            for target in adapters["layers"] for leaf in ("a", "b")}
        del ref_grads
    rep["train"] = train
    rep["peak_gb"] = _par_peak_gb(dev)
    return rep


def _par_check(cond, msg):
    if not cond:
        raise AssertionError(f"phase_parallel: {msg}")


def _par_summary(world_a, world_b, size, on_card):
    """Print every part's numbers and raise on a failed gate."""
    b, t, h, d = size["shape"]
    print(f"[parallel] backend {world_a[0]['backend']} ({PAR_RANKS} ranks, then {PAR_SP}, on one card; "
          f"the K/V rotations and gathers staged through pinned host buffers)")
    launches = {}
    for name, _ in PAR_OPS:
        recs = [w["attn"]["ops"][name] for w in world_a]
        r0 = recs[0]
        _par_check(all(r["digest"] == r0["digest"] for r in recs), f"{name}: ranks returned different results")
        _par_check(r0["finite"] and r0["out_ok"], f"{name}: output vs one-card flash max_abs_err "
                   f"{r0['max_abs_err']:.4e}, worst row at {r0['row_rel_err']:.4e} of its norm")
        _par_check(r0["grad_gap"] <= 1.0, f"{name}: gradients vs one-card flash at {r0['grad_gap']:.3f} of the bound")
        for rank, r in enumerate(recs):
            want = par_launches(name, rank, PAR_RANKS) if on_card else 0
            _par_check(r["launches"] == {**dict.fromkeys(FLASH_KEYS, want), **dict.fromkeys(NORM_KEYS, 0)},
                       f"{name} rank {rank}: launches {r['launches']}, want {want} each")
        launches[name] = {k: sum(r["launches"][k] for r in recs) for k in COUNT_KEYS}
        print(f"[parallel] (1) {name} [{b}, {t}, {h}, {d}] {str(size['dtype'])[6:]}: fwd "
              f"{max(r['fwd_ms'] for r in recs):.1f} ms, bwd {max(r['bwd_ms'] for r in recs):.1f} ms (slowest rank); "
              f"vs one-card flash max_abs_err={r0['max_abs_err']:.4e} (tol {PAR_TOL:g}), worst row "
              f"{r0['row_rel_err']:.4e} of its norm (tol {PAR_ROW_TOL:g}), grads at "
              f"{r0['grad_gap']:.3f} of the bound; launches per rank {[r['launches']['fwd'] for r in recs]}; "
              f"staged {r0['staged_mb']:.1f} MB in {r0['staged_ms']:.1f} ms (rank 0)")
    step = world_a[0]["attn"]["step"]
    if on_card:
        print(f"[parallel] ring step at T_local={t // PAR_RANKS}: kernel {step['kernel_ms']:.3f} ms (flash fwd, one "
              f"block, rank 0 alone; zigzag's two half blocks {step['zigzag_kernel_ms']:.3f} ms) vs rotation "
              f"{step['rotation_ms']:.3f} ms of {step['rotation_mb']:.1f} MB K/V ({step['staged_mb']:.1f} MB staged "
              f"in {step['staged_ms']:.3f} ms, rank 0); _merge_partial {step['merge_ms']:.4f} ms "
              f"(bound {step['merge_bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms, {step['merge_bytes'] / 1e6:.1f} MB)")

    tp = [w["tp"] for w in world_a]
    _par_check(all(r["digest"] == tp[0]["digest"] for r in tp), "TP/FSDP: ranks returned different logits")
    _par_check(tp[0]["finite"] and tp[0]["gap"] <= LOGIT_REL_TOL * tp[0]["span"],
               f"TP/FSDP logits vs unsharded: max_abs_diff {tp[0]['gap']:.4e}, max|logit| {tp[0]['span']:.4e}")
    want = PAR_TP_LAYERS if on_card else 0
    # Every rank's norms on the kernels: a forward pass over its gathered rows.
    want_tp = {"fwd": want, "norm_fwd": _norm_pass(PAR_TP_LAYERS) * bool(on_card), "norm_bwd": 0, "norm_dscale": 0}
    _par_check(all({k: r["launches"][k] for k in want_tp} == want_tp for r in tp),
               f"TP/FSDP launches {[r['launches'] for r in tp]}, want {want_tp}")
    launches["tp_fsdp"] = {k: sum(r["launches"][k] for r in tp) for k in COUNT_KEYS}
    print(f"[parallel] (3) TP/FSDP {{fsdp: 2, tp: 2}} {size['llama']} width, {PAR_TP_LAYERS} layers, B=1 "
          f"T={size['tp_len']}: forward {max(r['ms'] for r in tp):.1f} ms; logits vs unsharded "
          f"max_abs_diff={tp[0]['gap']:.4e} max|logit|={tp[0]['span']:.4e} (tol {LOGIT_REL_TOL:g}*max|logit|); "
          f"params held per rank {tp[0]['local_param_gb']:.3f} GB; flash launches per rank {want}")

    mo = [w["moe"] for w in world_a]
    _par_check(all(r["digest"] == mo[0]["digest"] for r in mo), "MoE: ranks returned different outputs")
    _par_check(mo[0]["ok"] and mo[0]["aux_ok"], f"MoE ep={PAR_RANKS} vs one rank: max_abs_err {mo[0]['max_abs_err']:.4e}")
    print(f"[parallel] (4) MoE {size['moe']} B={size['moe_batch']} T={size['moe_len']} ep={PAR_RANKS} "
          f"({mo[0]['local_experts']} experts a rank): {max(r['ms'] for r in mo):.1f} ms vs one rank "
          f"{mo[0]['one_rank_ms']:.1f} ms; max_abs_err={mo[0]['max_abs_err']:.4e} (tol {MOE_TOL:g}); "
          f"dropped {mo[0]['dropped']:.4f}")

    serve = [w["serve"] for w in world_b]
    s0 = serve[0]
    _par_check(all(r["digest"] == s0["digest"] for r in serve), "sp=2 prefill: ranks returned different logits")
    _par_check(s0["finite"] and s0["gap"] <= LOGIT_REL_TOL * s0["span"],
               f"sp=2 prefill logits vs one card: {s0['gap']:.4e} over max|logit| {s0['span']:.4e}")
    _par_check(s0["cache_gap"] <= LOGIT_REL_TOL * s0["cache_span"], f"sp=2 prefill KV cache vs one card {s0['cache_gap']:.4e}")
    layers = size["sp_layers"]
    per_layer = 2 * PAR_SP + 1
    want = {"fwd": per_layer * layers, "bwd_dq": 0, "bwd_dkv": 0, "norm_fwd": _norm_pass(layers), "norm_bwd": 0,
            "norm_dscale": 0}
    want = want if on_card else dict.fromkeys(want, 0)
    _par_check(all(r["launches"] == want for r in serve),
               f"sp=2 prefill launches {[r['launches'] for r in serve]}, want {want}")
    launches["sp_llama_serve"] = {k: sum(r["launches"][k] for r in serve) for k in COUNT_KEYS}
    print(f"[parallel] (2) {size['llama']} at {layers} layers, sp={PAR_SP} zigzag prefill B=1 T={size['prefill_len']}: "
          f"{max(r['ms'] for r in serve):.1f} ms; last logits vs one-card flash max_abs_diff={s0['gap']:.4e} "
          f"max|logit|={s0['span']:.4e} (tol {LOGIT_REL_TOL:g}*max|logit|), last layer's K cache "
          f"{s0['cache_gap']:.4e} of max {s0['cache_span']:.4e}; KV cache {s0['cache_gb']:.3f} GB a rank; "
          f"flash fwd launches per rank {serve[0]['launches']['fwd']}; staged {s0['staged_mb']:.1f} MB (rank 0)")

    train = [w["train"] for w in world_b]
    t0_ = train[0]
    _par_check(all(r["digest"] == t0_["digest"] for r in train) and all(r["finite"] for r in train),
               "sp=2 LoRA step: ranks disagree or the step is not finite")
    rel = abs(t0_["loss"] - t0_["ref_loss"]) / abs(t0_["ref_loss"])
    _par_check(rel <= GRAD_REL_TOL, f"sp=2 LoRA loss {t0_['loss']:.6f} vs one card {t0_['ref_loss']:.6f}")
    worst = 0.0
    for leaf, (gap, span) in t0_["grad_gaps"].items():
        _par_check(span > 0 and gap <= GRAD_REL_TOL * span, f"sp=2 adapter gradient d{leaf}: {gap:.4e} vs max|g| {span:.4e}")
        worst = max(worst, gap / span)
    # The norms as a one-card LoRA step's (remat), on each rank's rows.
    norms = {k: n for k, n in _lora_step_want(layers).items() if k in NORM_KEYS}
    want = {"fwd": 2 * per_layer * layers, "bwd_dq": per_layer * layers, "bwd_dkv": per_layer * layers, **norms}
    want = want if on_card else {k: 0 for k in want}
    _par_check(all(r["launches"] == want for r in train), f"sp=2 LoRA step launches {[r['launches'] for r in train]}, want {want}")
    launches["sp_llama_train"] = {k: sum(r["launches"][k] for r in train) for k in COUNT_KEYS}
    print(f"[parallel] (2) {size['llama']} at {layers} layers, sp={PAR_SP} LoRA step (rank {LORA_RANK} w[qv], remat) B=1 "
          f"T={size['train_len']}: {max(r['ms'] for r in train):.1f} ms; loss {t0_['loss']:.6f} vs one-card flash "
          f"{t0_['ref_loss']:.6f}; worst adapter gradient gap {worst:.4f} of max|g| (tol {GRAD_REL_TOL:g}); "
          f"launches per rank {train[0]['launches']}; staged {t0_['staged_mb']:.1f} MB (rank 0)")
    print(f"[parallel] peak memory per rank: world A {[round(w['peak_gb'], 2) for w in world_a]} GB, "
          f"world B {[round(w['peak_gb'], 2) for w in world_b]} GB; Llama init {world_b[0]['init_s']:.1f} s")
    launches["sp_ops"] = {k: sum(launches[n][k] for n, _ in PAR_OPS) for k in COUNT_KEYS}
    # fold_fma's launches on each path, read from every rank's counter
    fold_launches = {
        "sp_ops": sum(w["attn"]["ops"][n]["fold_launches"] for w in world_a for n, _ in PAR_OPS),
        "sp_llama_serve": sum(r["fold_launches"] for r in serve),
        "sp_llama_train": sum(r["fold_launches"] for r in train),
        "tp_fsdp": sum(r["fold_launches"] for r in tp),
    }
    print(f"[parallel] fold_fma launches, all ranks: {fold_launches}")
    return {"launches": launches, "fold_launches": fold_launches, "step": step, "ops": world_a[0]["attn"]["ops"]}


def phase_parallel(device=None):
    """Party-local parallelism on the card: two worlds of rank processes
    (parts 1, 3, 4 on 4 ranks, then part 2 on 2), each part held against its
    one-card form.  ``device="cpu"`` rehearses it at toy sizes."""
    from rayfed_tpu_torch.parallel.launch import run_world

    kind = "cpu" if device is not None and torch.device(device).type == "cpu" else "cuda"
    size = PAR_SIZES[kind]
    if kind == "cuda":
        torch.cuda.empty_cache()
    walls = {}
    t0 = time.perf_counter()
    world_a = run_world(_par_world_ops, PAR_RANKS, (size,), device=device, timeout_s=PAR_TIMEOUT_S)
    walls["ops_tp_moe"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    world_b = run_world(_par_world_llama, PAR_SP, (size,), device=device, timeout_s=PAR_TIMEOUT_S)
    walls["llama_sp"] = time.perf_counter() - t0
    print(f"[parallel] worlds: {PAR_RANKS} ranks (attention ops {world_a[0]['attn_wall_s']:.1f} s, TP/FSDP "
          f"{world_a[0]['tp_wall_s']:.1f} s, MoE {world_a[0]['moe_wall_s']:.1f} s) in {walls['ops_tp_moe']:.1f} s; "
          f"{PAR_SP} ranks (Llama sp) in {walls['llama_sp']:.1f} s, rank start-up included")
    out = _par_summary(world_a, world_b, size, kind == "cuda")
    out["walls"] = walls
    return out


# ---------------------------------------------------------------------------
# phase_pipeline: pipeline parallelism (a world of 4 ranks on the one card)
# ---------------------------------------------------------------------------

# The card's sizes and a CPU rehearsal's: Llama-3-8B at full width, the
# stage a run of its decoder layers with flash attention, B=8 sequences of
# 2048 tokens in M=8 microbatches of one.  (a) GPipe's forward at full depth
# (32 layers, 8 a stage); (b) one 1F1B step and (c) one interleaved step
# (pp=2, v=2, on the world's first two ranks) at 8 layers, where the
# one-card autograd reference fits beside the four ranks' weights.
PIPE_SIZES = {
    "cuda": dict(llama="llama3_8b", llama_kw=dict(param_dtype=torch.bfloat16), batch=8, seq=2048,
                 train_layers=8),
    "cpu": dict(llama="llama_tiny", llama_kw=dict(num_layers=8), batch=8, seq=16, train_layers=8),
}
PIPE_RANKS, PIPE_MB = 4, 8
PIPE_INTER = (2, 2)  # the interleaved schedule's (pp, v)
PIPE_LOSS_TOL = 1e-3  # the losses' relative gap; gradients GRAD_REL_TOL of max|g|, logits LOGIT_REL_TOL
PIPE_TIMEOUT_S = 420
PIPE_PATHS = ("pp_gpipe", "pp_1f1b", "pp_interleaved")  # launches_by_path keys


def pp_launches(schedule, layers, m):
    """Each flash kernel's launches on one rank of one pipeline call
    (PERF.md), idle ticks skipped, ``layers`` the rank's decoder layers
    (over all its chunks): GPipe M·layers forward; 1F1B and the
    interleaved schedule 2·M·layers forward (the forward and the backward's
    recompute) and M·layers each of dQ and dK/dV."""
    if schedule == "gpipe":
        return {"fwd": m * layers, "bwd_dq": 0, "bwd_dkv": 0}
    return {"fwd": 2 * m * layers, "bwd_dq": m * layers, "bwd_dkv": m * layers}


def _init_llama_lean(cfg, seed, dev):
    """``llama.init_llama``'s tree and scales, drawn a row block at a time in
    f32 (no f32 copy of a whole stacked leaf: four ranks build the 16 GB
    model on the one card at once)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, dh, h, kv, f, n = (cfg.hidden_size, cfg.head_dim, cfg.num_heads, cfg.num_kv_heads,
                          cfg.intermediate_size, cfg.num_layers)

    def normal(shape, std, block=512):
        out = torch.empty(shape, dtype=cfg.param_dtype, device=dev)
        flat = out.view(-1, shape[-1])
        for i in range(0, flat.shape[0], block):
            rows = flat[i:i + block]
            rows.copy_(torch.randn(rows.shape, generator=gen, device=dev) * std)
        return out

    ones = lambda *shape: torch.ones(shape, dtype=cfg.param_dtype, device=dev)  # noqa: E731
    params = {
        "embed": normal((cfg.vocab_size, d), 0.02 * d**0.5),
        "layers": {
            "attn_norm": ones(n, d), "wq": normal((n, d, h * dh), d**-0.5), "wk": normal((n, d, kv * dh), d**-0.5),
            "wv": normal((n, d, kv * dh), d**-0.5), "wo": normal((n, h * dh, d), (h * dh) ** -0.5),
            "mlp_norm": ones(n, d), "w_gate": normal((n, d, f), d**-0.5), "w_up": normal((n, d, f), d**-0.5),
            "w_down": normal((n, f, d), f**-0.5),
        },
        "final_norm": ones(d),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size), d**-0.5)
    return params


def _pipe_timed(dev, fn, group=None):
    """Run one pipeline call from zeroed counters, timed from a barrier of
    ``group``: its result and what this rank ran (ms, each kernel's
    launches, the schedule's ticks and hops, the bytes staged, peak memory)."""
    import torch.distributed as dist

    from rayfed_tpu_torch.parallel import collectives as coll
    from rayfed_tpu_torch.parallel import pipeline as pp

    _par_zero()
    coll.STAGING.reset()
    pp.STATS.reset()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    dist.barrier(group=group)
    _par_sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _par_sync(dev)
    return out, {"ms": (time.perf_counter() - t0) * 1e3, "launches": _counts(),
                 "fold_launches": fold.fold_fma_.launches, "stats": dataclasses.asdict(pp.STATS),
                 "staged_mb": coll.STAGING.bytes / 1e6, "staged_ms": coll.STAGING.ms, "peak_gb": _par_peak_gb(dev)}


def _pipe_grad_gaps(grads, ref):
    """Each stacked leaf's max|g − ref| and max|ref| (``ref`` may wait on the host)."""
    gaps = {}
    for k in ref:
        g, r = grads[k].float(), ref[k].to(grads[k].device).float()
        gaps[k] = (float((g - r).abs().max()), float(r.abs().max()))
    return gaps


def _pipe_world(rank, dev, size):
    """The pipeline phase's rank program (see PIPE_SIZES)."""
    import torch.distributed as dist

    from rayfed_tpu_torch.parallel import pipeline as pp
    from rayfed_tpu_torch.parallel.mesh import create_mesh
    from rayfed_tpu_torch.tools.parallel_check import llama_stage_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = getattr(llama, size["llama"])(**size["llama_kw"])
    t0 = time.perf_counter()
    params = _init_llama_lean(cfg, SEED, dev)
    _par_sync(dev)
    rep = {"backend": dist.get_backend(), "init_s": time.perf_counter() - t0, "layers": cfg.num_layers}
    mesh = create_mesh({"pp": PIPE_RANKS}, device=dev.type)
    inter_mesh = create_mesh({"pp": PIPE_INTER[0]}, list(range(PIPE_INTER[0])), device=dev.type)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    ids = torch.randint(0, cfg.vocab_size, (size["batch"], size["seq"]), generator=gen, device=dev)
    stage = llama_stage_fn(cfg, flash_attention, size["seq"], dev)
    with torch.no_grad():
        x = params["embed"].to(cfg.dtype)[ids]  # the embedding stays outside the pipe

        # (a) GPipe's forward at full depth, against the one-card model.
        fwd = pp.make_pipeline(mesh, stage, num_microbatches=PIPE_MB)
        # Untimed, one microbatch: each kernel's and buffer's first call.
        pp.make_pipeline(mesh, stage, num_microbatches=1)(params["layers"], x[:1])
        h, rec = _pipe_timed(dev, lambda: fwd(params["layers"], x))
        rec["digest"] = _digest(h)

        def shrink():
            # (b) and (c) run at train_layers, the first layers of the same
            # model: a leaf at a time, so the card holds one extra leaf.
            for k, v in params["layers"].items():
                params["layers"][k] = v[: size["train_layers"]].clone()
                del v
            if dev.type == "cuda":
                torch.cuda.empty_cache()

        # Rank 0 keeps the whole model for its one-card reference while the
        # others shrink: four whole models leave no room for it on one card.
        if rank:
            shrink()
        dist.barrier()
        if rank == 0:
            gap = span = 0.0
            for j in range(size["batch"]):  # a sequence at a time: B=8's f32 logits would take 8.4 GB
                logits = llama._lm_head(h[j:j + 1], params, cfg)
                ref = llama.apply_llama(params, ids[j:j + 1], cfg, attn_fn=flash_attention)
                gap = max(gap, float((logits - ref).abs().max()))
                span = max(span, float(ref.abs().max()))
                del logits, ref
            rec["gap"], rec["span"] = gap, span
            shrink()
        rep["gpipe"] = rec
        del h
        layers = params.pop("layers")
        dist.barrier()
    head = {k: params[k] for k in ("final_norm", "lm_head") if k in params}
    if cfg.tie_embeddings:
        head["embed"] = params["embed"]

    def loss_fn(y, tgt):  # lm_loss through the fixed head
        return llama.lm_loss(llama._lm_head(y, head, cfg)[:, :-1], tgt[:, 1:])

    # (b) one 1F1B step.
    train = pp.make_pipeline_train(mesh, stage, loss_fn, num_microbatches=PIPE_MB)
    pp.make_pipeline_train(mesh, stage, loss_fn, num_microbatches=1)(layers, x[:1], ids[:1])  # untimed
    (loss, grads), rec = _pipe_timed(dev, lambda: train(layers, x, ids))
    rec.update(loss=float(loss), digest=_digest(grads["wq"]))
    dist.barrier()
    if rank == 0:
        # One card, autograd: the mean microbatch loss, a microbatch at a
        # time, gradients summed in f32.
        ref_loss, ref = 0.0, {k: torch.zeros(v.shape, dtype=torch.float32, device=dev) for k, v in layers.items()}
        mb = size["batch"] // PIPE_MB
        for j in range(PIPE_MB):
            with torch.enable_grad():
                leaves = {k: v.detach().requires_grad_(True) for k, v in layers.items()}
                lj = loss_fn(stage(leaves, x[j * mb:(j + 1) * mb]), ids[j * mb:(j + 1) * mb]) / PIPE_MB
                gj = torch.autograd.grad(lj, list(leaves.values()))
            ref_loss += float(lj.detach())
            for k, g in zip(leaves, gj):
                ref[k] += g.float()
            del lj, gj, leaves
        rec["ref_loss"] = ref_loss
        rec["grad_gaps"] = _pipe_grad_gaps(grads, ref)
        del ref
    rep["1f1b"] = rec
    # Room for (c) on the card: rank 0 keeps (b)'s gradients on the host to
    # compare (c)'s with them, and the ranks outside (c) keep nothing.
    if rank == 0:
        grads = {k: v.cpu() for k, v in grads.items()}
    else:
        del grads
    if rank >= PIPE_INTER[0]:
        for tree in (layers, params, head):
            tree.clear()
        del x
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    dist.barrier()

    # (c) the interleaved schedule, pp=2, v=2 on ranks 0 and 1.
    rec = {"launches": dict.fromkeys(COUNT_KEYS, 0), "fold_launches": 0}
    if rank < PIPE_INTER[0]:
        inter = pp.make_pipeline_train(inter_mesh, stage, loss_fn, num_microbatches=PIPE_MB,
                                       virtual_stages=PIPE_INTER[1])
        pp.make_pipeline_train(inter_mesh, stage, loss_fn, num_microbatches=PIPE_INTER[0],  # untimed
                               virtual_stages=PIPE_INTER[1])(layers, x[:PIPE_INTER[0]], ids[:PIPE_INTER[0]])
        (loss_i, grads_i), rec = _pipe_timed(dev, lambda: inter(layers, x, ids), group=inter_mesh.get_group("pp"))
        rec.update(loss=float(loss_i), digest=_digest(grads_i["wq"]))
        if rank == 0:
            rec["grad_gaps"] = _pipe_grad_gaps(grads_i, grads)
        del grads_i
    rep["interleaved"] = rec
    dist.barrier()
    return rep


def _pipe_bubble(stats, schedule):
    """Idle ticks over all ticks: the interleaved schedule's ticks are a
    forward pass and its reversal, each unit a chunk's forward or backward."""
    live = 2 * stats["live"] if schedule == "interleaved" else stats["live"]
    return 1.0 - live / stats["ticks"]


def _pipe_check(cond, msg):
    if not cond:
        raise AssertionError(f"phase_pipeline: {msg}")


def _pipe_summary(ranks, size, on_card):
    """Print every part's numbers and raise on a failed gate."""
    layers = ranks[0]["layers"]
    hop_mb = lambda s: s["hop_bytes"] / max(1, s["hops"]) / 1e6  # noqa: E731
    print(f"[pipeline] backend {ranks[0]['backend']} ({PIPE_RANKS} ranks on one card; the hops and the "
          f"replicating broadcasts staged through pinned host buffers); {size['llama']}, B={size['batch']} "
          f"T={size['seq']}, M={PIPE_MB}; init {max(r['init_s'] for r in ranks):.1f} s")
    out = {"launches": {}, "fold_launches": {}}
    parts = (("gpipe", "pp_gpipe", PIPE_RANKS, layers // PIPE_RANKS),
             ("1f1b", "pp_1f1b", PIPE_RANKS, size["train_layers"] // PIPE_RANKS),
             ("interleaved", "pp_interleaved", PIPE_INTER[0], size["train_layers"] // PIPE_INTER[0]))
    for part, path, n, per_rank in parts:
        recs = [r[part] for r in ranks]
        live = recs[:n]
        _pipe_check(all(r["digest"] == live[0]["digest"] for r in live), f"{part}: ranks returned different results")
        for rank, r in enumerate(recs):
            want = pp_launches("gpipe" if part == "gpipe" else "train", per_rank, PIPE_MB) if rank < n else \
                {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
            want = want if on_card else {k: 0 for k in want}
            _pipe_check(_flash(r["launches"]) == want, f"{part} rank {rank}: launches {r['launches']}, want {want}")
            # The norms of a live rank's layers on the kernels (and, training,
            # their backward with dscale: the stages' norm scales train).
            norms = {k: r["launches"][k] > 0 for k in NORM_KEYS}
            want_norms = {"norm_fwd": True, "norm_bwd": part != "gpipe", "norm_dscale": part != "gpipe"}
            want_norms = {k: v and on_card and rank < n for k, v in want_norms.items()}
            _pipe_check(norms == want_norms, f"{part} rank {rank}: norm launches {r['launches']}, want > 0 where "
                                             f"{want_norms}")
        out["launches"][path] = {k: sum(r["launches"][k] for r in recs) for k in COUNT_KEYS}
        out["fold_launches"][path] = sum(r["fold_launches"] for r in recs)
        bubble = [round(_pipe_bubble(r["stats"], part), 4) for r in live]
        common = (f"{max(r['ms'] for r in live):.1f} ms (slowest rank); bubble {bubble}; hop "
                  f"{hop_mb(live[0]['stats']):.1f} MB, hops a rank {[r['stats']['hops'] for r in live]}; staged "
                  f"{[round(r['staged_mb'], 1) for r in live]} MB in {[round(r['staged_ms'], 1) for r in live]} ms; "
                  f"launches per rank {[r['launches']['fwd'] for r in recs]} fwd; peak memory "
                  f"{[round(r['peak_gb'], 2) for r in live]} GB")
        r0 = recs[0]
        if part == "gpipe":
            _pipe_check(r0["gap"] <= LOGIT_REL_TOL * r0["span"],
                        f"GPipe logits vs one card {r0['gap']:.4e} over max|logit| {r0['span']:.4e}")
            print(f"[pipeline] (a) GPipe pp={n}, {layers} layers ({per_rank} a stage) forward: {common}; logits vs "
                  f"one-card apply_llama max_abs_diff={r0['gap']:.4e} max|logit|={r0['span']:.4e} "
                  f"(tol {LOGIT_REL_TOL:g}*max|logit|)")
            continue
        ref_loss = r0["ref_loss"] if part == "1f1b" else ranks[0]["1f1b"]["loss"]
        rel = abs(r0["loss"] - ref_loss) / abs(ref_loss)
        _pipe_check(rel <= PIPE_LOSS_TOL, f"{part} loss {r0['loss']:.6f} vs {ref_loss:.6f}")
        worst = 0.0
        for leaf, (gap, span) in r0["grad_gaps"].items():
            _pipe_check(span > 0 and gap <= GRAD_REL_TOL * span, f"{part} d{leaf}: {gap:.4e} vs max|g| {span:.4e}")
            worst = max(worst, gap / span)
        what = ("1F1B", "one-card autograd") if part == "1f1b" else (f"interleaved pp={n} v={PIPE_INTER[1]}", "1F1B")
        print(f"[pipeline] ({'b' if part == '1f1b' else 'c'}) {what[0]}, {size['train_layers']} layers "
              f"({per_rank} a rank) step: {common}; loss {r0['loss']:.6f} vs {what[1]} {ref_loss:.6f} "
              f"(tol {PIPE_LOSS_TOL:g} rel); worst stacked gradient gap {worst:.4f} of max|g| (tol {GRAD_REL_TOL:g})")
        out[part] = {"ms": max(r["ms"] for r in live), "loss": r0["loss"], "worst": worst}
    print(f"[pipeline] fold_fma launches, all ranks: {out['fold_launches']}")
    return out


def phase_pipeline(device=None):
    """Pipeline parallelism on the card: one world of 4 rank processes runs
    GPipe's forward, a 1F1B step and an interleaved step of Llama-3-8B
    decoder layers on the flash kernels, each held against its one-card
    form.  ``device="cpu"`` rehearses it at toy sizes."""
    from rayfed_tpu_torch.parallel.launch import run_world

    kind = "cpu" if device is not None and torch.device(device).type == "cpu" else "cuda"
    size = PIPE_SIZES[kind]
    if kind == "cuda":
        torch.cuda.empty_cache()
        print(f"[pipeline] this process holds {torch.cuda.memory_allocated() / 1e9:.2f} GB on the card "
              f"({torch.cuda.memory_reserved() / 1e9:.2f} GB reserved) beside the four ranks")
    t0 = time.perf_counter()
    ranks = run_world(_pipe_world, PIPE_RANKS, (size,), device=device, timeout_s=PIPE_TIMEOUT_S)
    print(f"[pipeline] world of {PIPE_RANKS} ranks in {time.perf_counter() - t0:.1f} s, rank start-up included")
    return _pipe_summary(ranks, size, kind == "cuda")


# ---------------------------------------------------------------------------
# phase_party_processes: a party of two processes (the multi-process party)
# ---------------------------------------------------------------------------

# Five processes: alice's two (one card each: the one card here), bob,
# carol and dave.  Runtime A, alice one process (her second sits out): one
# BASELINE #3 round, the reference.  Runtime B, alice two processes with the
# party mesh {"dp": 2}: (a) bob pushes a 64 MB tensor to both, (c) the
# collective cap change, (b) the same round with alice's step data-parallel
# over her two ranks, (d) her leader killed while her member waits.
PARTY_PROCS = ("alice0", "alice1", "bob", "carol", "dave")
PARTY_TIMEOUT_S = 300
PARTY_BULK = (4096, 4096)  # f32: 64 MB
PARTY_HALVES = 2  # alice's step: the mean gradient of two halves of her shard
PARTY_CAP = 96 * 1024 * 1024  # the cap the collective sets, and sets back
PARTY_SLOW_S = 8.0  # bob's task in (d): longer than the watchdog's deadline, far below the backstop
PARTY_KILL_AFTER_S = 2.0
PARTY_INIT = dict(
    cross_silo_retry_policy={"maxAttempts": 2, "initialBackoff": "0.2s", "maxBackoff": "0.5s"},
    enable_waiting_for_other_parties_ready=True, peer_health_interval_in_seconds=0.5,
    peer_death_pings=2, cross_silo_timeout_in_seconds=15, recv_backstop_in_seconds=60,
)


class _DPResNetTrainer:
    """BASELINE #3's trainer (``_ResNetTrainer``'s shard and step: one SGD
    step, momentum 0.9 from zero, per round) whose gradient is the mean of
    ``halves`` equal halves' gradients (and its BN state their mean): in a
    party of two processes each takes its own half and the mean is an
    all-reduce over the party mesh; in one process both, one after another."""

    def __init__(self, seed, device, halves):
        from rayfed_tpu_torch.models import resnet

        base = _ResNetTrainer(seed, device)
        self.x, self.y, self.halves = base.x, base.y, halves
        self.cfg = resnet.resnet18(num_classes=10)
        self.report = {}

    def train(self, bundle):
        import torch.distributed as dist

        from rayfed_tpu_torch.fl.compression import pack_tree, unpack_tree
        from rayfed_tpu_torch.models import resnet
        from rayfed_tpu_torch.parallel import collectives as coll
        from rayfed_tpu_torch.runtime import get_runtime

        params, state = unpack_tree(bundle, torch.float32)

        def loss_fn(p, s, x, y):
            logits, new_state = resnet.apply_resnet(p, s, x, self.cfg, train=True)
            return softmax_cross_entropy(logits, y), new_state

        mesh = get_runtime().mesh
        group = mesh.get_group("dp") if mesh is not None and mesh.size() > 1 else None
        n = len(self.x) // self.halves
        mine = [dist.get_rank(group)] if group is not None else range(self.halves)
        tree = None
        for i in mine:
            (_, new_state), grads = value_and_grad(loss_fn, params, state, self.x[i * n:(i + 1) * n],
                                                   self.y[i * n:(i + 1) * n], has_aux=True)
            part = (grads, new_state)
            tree = part if tree is None else torch.utils._pytree.tree_map(torch.add, tree, part)
        leaves, spec = torch.utils._pytree.tree_flatten(tree)
        if group is not None:
            leaves = [coll.all_reduce_sum(x, group) for x in leaves]
        grads, new_state = torch.utils._pytree.tree_unflatten([x / self.halves for x in leaves], spec)
        params = torch.utils._pytree.tree_map(lambda p, g: p - RESNET_LR * g, params, grads)
        self.report = {"images": len(mine) * n, "ranks": 1 if group is None else dist.get_world_size(group)}
        return pack_tree((params, new_state), torch.bfloat16)

    def last_step(self):
        return self.report


def _party_round(fed, party, dev):
    """One BASELINE #3 round (coordinator bob) from the seed's params: the
    final tree, on this process's device, and alice's trainer's report."""
    from rayfed_tpu_torch.models import resnet

    params0 = resnet.init_resnet(torch.Generator().manual_seed(SEED), resnet.resnet18(num_classes=10), device=dev)
    trainers = {p: fed.remote(_DPResNetTrainer).party(p).remote(SEED + 1 + i, dev, PARTY_HALVES if p == "alice" else 1)
                for i, p in enumerate(TOPO_PARTIES)}
    _par_zero()
    t0 = time.perf_counter()
    final = fl.run_fedavg_rounds(trainers, params0, rounds=1, compress_wire=True, packed_wire=True,
                                 coordinator="bob")
    rep = {"s": time.perf_counter() - t0, "fold_launches": fold.fold_fma_.launches, "flash_launches": _counts(),
           "digest": _leaf_digest(final),
           "alice": fed.get(trainers["alice"].last_step.remote())}
    return params0, final, rep


def _tree_gap(a, b):
    """max|a − b| over the leaves of two trees of the same paths (their dict
    orders may differ)."""
    flat = lambda t: {torch.utils._pytree.keystr(k): v  # noqa: E731
                      for k, v in torch.utils._pytree.tree_flatten_with_path(t)[0]}
    fa, fb = flat(a), flat(b)
    if sorted(fa) != sorted(fb):
        raise AssertionError(f"trees differ in their leaves: {sorted(set(fa) ^ set(fb))}")
    return max(float((fa[k].float() - fb[k].float()).abs().max()) for k in fa)


def _party_proc(name, ports, device, root, out):
    """A process of the party phase (``name`` one of PARTY_PROCS)."""
    _deterministic()
    import rayfed_tpu_torch as fed
    from rayfed_tpu_torch.exceptions import RemoteError
    from rayfed_tpu_torch.parallel import collectives as coll
    from rayfed_tpu_torch.runtime import get_runtime

    party = "alice" if name.startswith("alice") else name
    rep = {"party": name}
    try:
        # Runtime A: alice in one process (alice0), the reference round.
        if name != "alice1":
            cluster = {p: {"address": f"127.0.0.1:{port}"} for p, port in zip(TOPO_PARTIES, ports["one"])}
            dev = fed.init(address="local", cluster=cluster, party=party, device=device, **PARTY_INIT).transport.device
            params0, final_a, rep["one"] = _party_round(fed, party, dev)
            fed.shutdown()

        # Runtime B: alice in two processes.
        cluster = {p: {"address": f"127.0.0.1:{port}"} for p, port in zip(TOPO_PARTIES, ports["two"])}
        kw = dict(PARTY_INIT)
        if party == "alice":
            kw.update(coordinator_address=f"127.0.0.1:{ports['coord']}", num_party_processes=2,
                      party_process_id=int(name[-1]), mesh_shape={"dp": 2})
        t0 = time.perf_counter()
        rt = fed.init(address="local", cluster=cluster, party=party, device=device, **kw)
        rep["init_s"] = time.perf_counter() - t0
        # A large broadcast goes eagerly, never as a handle: alice's member
        # has no object plane to pull one with (its bridge only receives).
        rt.job_config.blob_broadcast_min_bytes = None
        dev, tm = rt.transport.device, rt.transport
        if party == "alice":
            rep["mesh"] = {"shape": list(rt.mesh.mesh.shape), "rank": torch.distributed.get_rank(),
                           "backend": torch.distributed.get_backend(), "device": str(dev)}

        # (a) bob's 64 MB to both of alice's processes, then a sum over her mesh.
        @fed.remote
        def make_bulk():
            gen = torch.Generator(device=dev).manual_seed(SEED + 7)
            return torch.randn(PARTY_BULK, generator=gen, device=dev)

        @fed.remote
        def bulk_digest(x):
            return _digest(x)

        @fed.remote
        def bulk_check(x):
            mesh = get_runtime().mesh
            group = mesh.get_group("dp")
            r, n = torch.distributed.get_rank(group), mesh.size()
            rows = x.shape[0] // n
            coll.STAGING.reset()
            total = coll.all_reduce_sum(x[r * rows:(r + 1) * rows].double().sum(), group)
            return {"digest": _digest(x), "device": str(x.device), "sum": float(total),
                    "local_sum": float(x.double().sum()), "staged_b": coll.STAGING.bytes}

        log0 = tm.transfer_log.total_recorded
        bulk = make_bulk.party("bob").remote()
        sent_digest = bulk_digest.party("bob").remote(bulk)
        checked = bulk_check.party("alice").remote(bulk)
        t0 = time.perf_counter()
        checked = fed.get(checked)  # each alice process: its own result
        if party == "alice":
            rep["bulk"] = dict(checked, get_s=time.perf_counter() - t0)
            recs, _ = tm.transfer_log.records_since(log0)
            rep["bulk"]["transfers"] = [(r.direction, r.peer, r.nbytes, r.seconds) for r in recs]
        rep["bulk_digest"] = fed.get(sent_digest)

        # (c) the collective cap change: every alice process at once.
        if party == "alice":
            def caps():  # the cap this process's listener enforces: the wire's, or the bridge's
                return (tm._inner if tm._inner is not None else tm._bridge_mgr)._server._max_message_size

            before = caps()
            t0 = time.perf_counter()
            tries = _collective_cap(fed, PARTY_CAP)
            rep["cap"] = {"before": before, "set": caps(), "ms": (time.perf_counter() - t0) * 1e3, "tries": tries}
            _collective_cap(fed, before)
            rep["cap"]["restored"] = caps()

        # (b) the same round, alice's step data-parallel over her two ranks.
        _, final_b, rep["two"] = _party_round(fed, party, dev)
        if name != "alice1":
            rep["two"]["gap"] = _tree_gap(final_b, final_a)
            rep["two"]["delta"] = _tree_gap(final_a, params0)

        # (d) alice's leader dies while her member waits on bob's value.
        @fed.remote
        def slow():
            time.sleep(PARTY_SLOW_S)
            return 1

        value = slow.party("bob").remote()
        kill_file = os.path.join(root, "leader_killed")
        if name == "alice0":
            time.sleep(PARTY_KILL_AFTER_S)
            out.put(rep)
            out.close()
            out.join_thread()
            with open(kill_file, "w") as f:
                f.write(repr(time.time()))
            os._exit(CRASH_EXIT)  # no goodbyes: the sockets and the store die with it
        if name == "alice1":
            try:
                fed.get(value)
                rep["poisoned"] = None
            except RemoteError as e:
                t = time.time()
                with open(kill_file) as f:
                    rep["poisoned"] = {"s": t - float(f.read()), "error": str(e)[:160]}
            out.put(rep)
            out.close()
            out.join_thread()
            os._exit(0)  # the party's world lost its leader: leave without its teardown
        fed.get(value)
        fed.shutdown()
        out.put(rep)
    except BaseException:
        out.put({"party": name, "error": traceback.format_exc()})
        raise


def _collective_cap(fed, cap):
    """``fed.set_max_message_length(cap)`` on every process of the party: a
    send still in flight makes the whole party refuse it together (the
    same verdict at every process), and then every process tries again."""
    for tries in range(1, 51):
        try:
            fed.set_max_message_length(cap)
            return tries
        except RuntimeError as e:
            if "in flight" not in str(e):
                raise
            time.sleep(0.1)
    raise AssertionError(f"set_max_message_length({cap}) refused 50 times: sends stayed in flight")


def _party_check(cond, msg):
    if not cond:
        raise AssertionError(f"phase_party_processes: {msg}")


def _party_summary(reports, on_card):
    a0, a1, bob = reports["alice0"], reports["alice1"], reports["bob"]
    print(f"[party] alice in two processes: mesh {a0['mesh']} / {a1['mesh']}; init {a0['init_s']:.2f} / "
          f"{a1['init_s']:.2f} s (the party's store and world, the bridge)")
    # (a)
    for a in (a0, a1):
        b = a["bulk"]
        _party_check(b["digest"] == bob["bulk_digest"], f"{a['party']} received other bytes than bob sent")
        _party_check(b["sum"] == b["local_sum"], f"{a['party']}: the mesh's sum {b['sum']} vs {b['local_sum']}")
    bridge = [t for t in a1["bulk"]["transfers"] if t[0] == "recv"]
    wire_in = [t for t in a0["bulk"]["transfers"] if t[0] == "recv"]
    _party_check(bridge and bridge[0][2] >= PARTY_BULK[0] * PARTY_BULK[1] * 4, f"no bridge transfer at alice1: {bridge}")
    print(f"[party] (a) bob's {PARTY_BULK[0]}x{PARTY_BULK[1]} f32 ({PARTY_BULK[0] * PARTY_BULK[1] * 4 / 1e6:.1f} MB): "
          f"equal SHA-256 at bob and both alice processes ({a0['bulk']['device']}, {a1['bulk']['device']}); "
          f"sum over the mesh {a0['bulk']['sum']:.6e} (its all-reduce staged {a0['bulk']['staged_b']} B); "
          f"leader's wire recv {wire_in[0][2] / 1e6:.1f} MB in {wire_in[0][3] * 1e3:.1f} ms, bridge republish "
          f"{bridge[0][2] / 1e6:.1f} MB read in {bridge[0][3] * 1e3:.1f} ms "
          f"({bridge[0][2] / max(bridge[0][3], 1e-9) / 1e9:.2f} GB/s) at alice1; bob's task to alice's "
          f"result {a0['bulk']['get_s'] * 1e3:.1f} / {a1['bulk']['get_s'] * 1e3:.1f} ms")
    # (c)
    for a in (a0, a1):
        c = a["cap"]
        _party_check(c["set"] == PARTY_CAP and c["restored"] == c["before"], f"{a['party']} cap {c}")
    print(f"[party] (c) set_max_message_length({PARTY_CAP}) on both processes: "
          f"{a0['cap']['ms']:.1f} / {a1['cap']['ms']:.1f} ms (two store barriers and the leader's verdict), then back "
          f"to {a0['cap']['before']}")
    # (b)
    for p in ("alice0", "bob", "carol", "dave"):
        r = reports[p]
        _party_check(r["two"]["digest"] == reports["bob"]["two"]["digest"], f"{p}: the two-process round differs")
        _party_check(r["two"]["gap"] <= GRAD_REL_TOL * r["two"]["delta"],
                     f"{p}: two-process alice's round vs one-process {r['two']['gap']:.4e} over max|Δ| "
                     f"{r['two']['delta']:.4e}")
    _party_check(a1["two"]["digest"] == bob["two"]["digest"], "alice1's final differs")
    _party_check(a0["two"]["alice"] == {"images": RESNET_N // PARTY_HALVES, "ranks": 2} == a1["two"]["alice"],
                 f"alice's step was not data-parallel: {a0['two']['alice']}, {a1['two']['alice']}")
    _party_check(a0["one"]["alice"] == {"images": RESNET_N, "ranks": 1}, f"one-process alice {a0['one']['alice']}")
    if on_card:
        _party_check(bob["one"]["fold_launches"] > 0 and bob["two"]["fold_launches"] > 0,
                     f"bob's fold launched {bob['one']['fold_launches']}, {bob['two']['fold_launches']} times")
    print(f"[party] (b) BASELINE #3 round (resnet18, 4 parties, coordinator bob) with alice's step over her two "
          f"ranks ({RESNET_N // PARTY_HALVES} images each, gradients all-reduced): {bob['two']['s']:.2f} s vs "
          f"{bob['one']['s']:.2f} s with one alice process; final max|Δ two − one| {bob['two']['gap']:.4e} of "
          f"max|Δ| {bob['two']['delta']:.4e} (tol {GRAD_REL_TOL:g}); equal SHA-256 at all five processes; "
          f"fold_fma at bob {bob['two']['fold_launches']}")
    # (d)
    pz = a1["poisoned"]
    deadline = PARTY_INIT["peer_health_interval_in_seconds"] * (PARTY_INIT["peer_death_pings"] + 1) + 2.0
    _party_check(pz is not None and "leader" in pz["error"], f"alice1's parked recv was not poisoned: {pz}")
    _party_check(pz["s"] <= deadline, f"alice1 poisoned {pz['s']:.2f} s after the leader died (deadline {deadline} s)")
    print(f"[party] (d) alice's leader killed {PARTY_KILL_AFTER_S:g} s into bob's {PARTY_SLOW_S:g} s task: alice1's "
          f"parked recv raised {pz['s']:.2f} s after the kill (watchdog deadline {deadline:g} s, backstop "
          f"{PARTY_INIT['recv_backstop_in_seconds']} s): {pz['error']!r}")
    rounds = [reports[p][k] for p in PARTY_PROCS for k in ("one", "two") if k in reports[p]]
    return {"fold_launches": sum(r["fold_launches"] for r in rounds),
            "flash_launches": {k: sum(r["flash_launches"][k] for r in rounds) for k in ("fwd", "bwd_dq", "bwd_dkv")},
            "bridge_mb": bridge[0][2] / 1e6, "bridge_ms": bridge[0][3] * 1e3, "poison_s": pz["s"]}


def phase_party_processes(device=None):
    """A party of two processes on the card beside three of one: the bridge,
    the party mesh, a BASELINE #3 round with a data-parallel step, the
    collective cap and the leader's death.  ``device="cpu"`` rehearses it."""
    if device is None:
        torch.cuda.empty_cache()
    ports = {"one": _free_ports(4), "two": _free_ports(4), "coord": _free_ports(1)[0]}
    root = tempfile.mkdtemp(prefix="chip_smoke_party_")
    t0 = time.perf_counter()
    try:
        reports = _spawn_parties(_party_proc, (ports, device, root), PARTY_TIMEOUT_S, parties=PARTY_PROCS,
                                 exit_codes={"alice0": CRASH_EXIT})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[party] five processes in {time.perf_counter() - t0:.1f} s")
    return _party_summary(reports, device is None)


# phase_examples: the seven files of examples_torch/ as a user runs them, at
# their own sizes, rounds and seeds, each party process on the card.  Every
# example keeps the JAX examples' dense attention, so none launches a flash
# kernel; none packs its contribution (no compress_wire), so every round
# folds in `_mean_leaf`'s or the trimmed mean's plain ops and fold_fma
# launches nowhere either.  mesh_fedavg's parties are two processes each.
EXAMPLE_RUNS = (
    ("simple_example", ("alice", "bob")),
    ("fedavg_mnist", ("alice", "bob")),
    ("robust_fedavg", ("alice", "bob", "carol")),
    ("mesh_fedavg", ("alice0", "alice1", "bob0", "bob1")),
    ("lora_finetune", ("alice", "bob")),
    ("split_fl_bert", ("alice", "bob")),
)
EXAMPLE_TIMEOUT_S = 180  # hard limit on each example's processes


def _example_proc(proc, example, cluster, coordinators, device, out):
    """A process of phase_examples: ``examples_torch.<example>.run`` for its
    party (``proc`` ends in the process id where a party is several), its
    runtime's device as the example's ``fed.init`` resolved it, its wall and
    its flash and fold launches."""
    import importlib

    import rayfed_tpu_torch as fed

    party = proc.rstrip("0123456789")
    rep = {"party": proc}
    try:
        init = fed.init

        def recording_init(*args, **kw):
            rt = init(*args, **kw)
            rep["device"] = str(rt.transport.device)
            return rt

        fed.init = recording_init
        kw = {"cluster": cluster}
        if device is not None:
            kw["device"] = device
        if coordinators is not None:
            kw.update(coordinators=coordinators, process_id=int(proc[len(party):]))
        run = importlib.import_module(f"examples_torch.{example}").run
        _zero_counts()
        fold.fold_fma_.launches = 0
        t0 = time.perf_counter()
        rep["result"] = run(party, **kw)
        rep["s"] = time.perf_counter() - t0
        rep["flash_launches"], rep["fold_launches"] = _counts(), fold.fold_fma_.launches
        out.put(rep)
    except BaseException:
        out.put({"party": proc, "error": traceback.format_exc()})
        raise


def _example_check(cond, msg):
    if not cond:
        raise AssertionError(f"phase_examples: {msg}")


def phase_examples(device=None):
    """The port's seven examples on the card: each federated one in its own
    party processes on free ports (the card shared over gloo where a party
    is two processes), serve_llama in this process.  Checks: every process
    exits 0 on ``cuda``, the examples' own assertions, equal results at
    every party, no flash or fold launch.  ``device="cpu"`` rehearses it."""
    from examples_torch import serve_llama

    on_card = device is None
    summary = {"s": {}, "results": {}, "flash_launches": dict.fromkeys(FLASH_KEYS, 0),
               "norm_launches": dict.fromkeys(NORM_KEYS, 0), "fold_launches": 0}
    if on_card:
        torch.cuda.empty_cache()

    def spawn(example, procs):
        parties = sorted({p.rstrip("0123456789") for p in procs})
        ports = _free_ports(2 * len(parties))
        cluster = {p: {"address": f"127.0.0.1:{port}"} for p, port in zip(parties, ports)}
        coordinators = ({p: f"127.0.0.1:{port}" for p, port in zip(parties, ports[len(parties):])}
                        if example == "mesh_fedavg" else None)
        t0 = time.perf_counter()
        reports = _spawn_parties(_example_proc, (example, cluster, coordinators, device), EXAMPLE_TIMEOUT_S,
                                 parties=procs)
        return reports, time.perf_counter() - t0

    # The examples run at once, each in its own processes on its own ports:
    # their walls are process start (~13 s a spawn on the card's host), not
    # their programs, and one after another they took 112-160 s.
    t_all = time.perf_counter()
    with ThreadPoolExecutor(len(EXAMPLE_RUNS)) as pool:
        futures = {example: pool.submit(spawn, example, procs) for example, procs in EXAMPLE_RUNS}
        spawned = {example: f.result() for example, f in futures.items()}
    summary["spawned_s"] = time.perf_counter() - t_all
    print(f"[examples] the six spawned examples at once in {summary['spawned_s']:.2f} s")
    for example, procs in EXAMPLE_RUNS:
        reports, wall = spawned[example]
        results = {p: reports[p]["result"] for p in procs}
        _example_check(len(set(results.values())) == 1, f"{example}: the parties' results differ: {results}")
        for p in procs:
            r = reports[p]
            _example_check(r["device"].startswith("cuda" if on_card else "cpu"),
                           f"{example}: {p} ran on {r['device']}")
            _example_check(not any(_flash(r["flash_launches"]).values()),
                           f"{example}: {p} launched flash kernels {r['flash_launches']}")
            _example_check(r["fold_launches"] == 0, f"{example}: {p} launched fold_fma {r['fold_launches']} times")
            _example_check(on_card or not any(r["flash_launches"][k] for k in NORM_KEYS),
                           f"{example}: {p} launched the RMSNorm kernels off the card")
            for k, v in r["flash_launches"].items():
                summary["norm_launches" if k in NORM_KEYS else "flash_launches"][k] += v
            summary["fold_launches"] += r["fold_launches"]
        summary["s"][example], summary["results"][example] = wall, results[procs[0]]
        runs = ", ".join(f"{p} {reports[p]['s']:.2f} s" for p in procs)
        folds = ", ".join(f"{p} {reports[p]['fold_launches']}" for p in procs)
        devices = sorted({reports[p]["device"] for p in procs})
        norms = {k: sum(reports[p]["flash_launches"][k] for p in procs) for k in NORM_KEYS}
        print(f"[examples] {example}: {len(procs)} processes on {devices}, {wall:.2f} s (runs {runs}); "
              f"returned {results[procs[0]]!r} at every party; flash launches 0; fold_fma {folds}; norms {norms}")
    _zero_counts()
    fold.fold_fma_.launches = 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    n = serve_llama.run(device=device)
    wall = time.perf_counter() - t0
    counts, folds = _counts(), fold.fold_fma_.launches
    flash, norms = _flash(counts), {k: counts[k] for k in NORM_KEYS}
    _example_check(n == serve_llama.NEW_TOKENS, f"serve_llama served {n} tokens")
    _example_check(not any(flash.values()) and folds == 0, f"serve_llama launched {flash}, fold_fma {folds}")
    # Its Llama's norms on the kernels on the card: forward passes only.
    _example_check((norms["norm_fwd"] > 0) == on_card and norms["norm_bwd"] == norms["norm_dscale"] == 0,
                   f"serve_llama's norm launches {norms}")
    for k, v in norms.items():
        summary["norm_launches"][k] += v
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    _example_check(not on_card or peak > 0, "serve_llama allocated nothing on the card")
    summary["s"]["serve_llama"], summary["results"]["serve_llama"] = wall, n
    print(f"[examples] serve_llama: in this process, {n} tokens a sequence in {wall:.2f} s, peak "
          f"{peak / 1e6:.1f} MB on the card; flash launches 0; fold_fma 0; norms {norms}")
    print(f"[examples] seven examples in {summary['spawned_s'] + wall:.1f} s")
    return summary

# -- bench_torch.py --smoke: the reference bench's CI legs and gates ----------

# Legs whose float folds run on the fold kernel on the card: the streamed
# FedAvg folds, the ring's stripe folds, the pipelined rounds' folds, the
# server step and resync.
BENCH_FOLD_LEGS = ("stream_agg", "ring_agg", "overlap", "server_opt")


# Legs of phase_bench_smoke run at once.  One after another the twelve took
# 318-384 s, a third of the script, which then ran 1018-1177 s of its 1200 s
# limit (H100 80GB HBM3, 700 W; PERF.md).  Two lanes run the same legs, sizes
# and gates; the timed gates' walls then share the host's cores.
BENCH_SMOKE_LANES = 2


def phase_bench_smoke(device=None):
    """``bench_torch.run_smoke``: the twelve legs of ``bench.py --smoke`` on
    the port, each in its own spawned processes with the parties on the card,
    ``BENCH_SMOKE_LANES`` legs at a time, and every gate of the reference at
    its threshold.  Fatal: a leg's error,
    a miss of an exact gate, a flash launch, no fold_fma launch in a leg of
    BENCH_FOLD_LEGS.  A timed gate (a ratio of walls) that misses is printed
    beside its value and does not fail the run.  ``device="cpu"`` rehearses
    it.  The record is written to chiprun_out/bench_smoke.json."""
    import bench_torch

    dev = "cuda" if device is None else device
    t0 = time.perf_counter()
    stats = {}
    record, failed = bench_torch.run_smoke(dev, stats=stats, lanes=BENCH_SMOKE_LANES)
    wall = time.perf_counter() - t0
    misses = {"exact": [], "timed": []}
    for gate in bench_torch.GATES:
        verdict = bench_torch.gate_passes(gate, record)
        state = "skipped" if verdict is None else ("pass" if verdict else "MISS")
        if verdict is False:
            misses[gate.kind].append(gate.name)
        want = "true" if gate.op == "true" else f"{gate.op} {gate.threshold!r}"
        print(f"[bench_smoke] {gate.name} ({gate.kind}): {record.get(gate.key)!r}, must be {want}: {state}")
    launches = {leg: st["launches"] for leg, st in stats.items()}
    for leg, st in stats.items():
        print(f"[bench_smoke] {leg}: {st['s']:.1f} s, launches {st['launches']}")
    flash = {k: sum(n.get(f"flash_{k}", 0) for n in launches.values()) for k in ("fwd", "bwd_dq", "bwd_dkv")}
    norms = _bench_norms(launches)
    folds = sum(n.get("fold_fma", 0) for n in launches.values())
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "bench_smoke.json"), "w") as f:
        json.dump({"record": record, "launches": launches, "failed": failed}, f, indent=1)
    errors = {k: record[k] for k in failed if k.endswith("_error")}
    print(f"[bench_smoke] twelve legs on {dev} in {wall:.1f} s; exact gates missed {misses['exact']}, timed "
          f"gates missed {misses['timed']}, leg errors {sorted(errors)}; fold_fma {folds}, flash {flash}, "
          f"norms {norms}")
    if errors or misses["exact"]:
        raise AssertionError(f"phase_bench_smoke: leg errors {errors}, exact gates missed {misses['exact']}")
    if any(flash.values()):
        raise AssertionError(f"phase_bench_smoke: flash kernels launched {flash}")
    if dev != "cpu" and not all(launches.get(leg, {}).get("fold_fma", 0) for leg in BENCH_FOLD_LEGS):
        raise AssertionError(f"phase_bench_smoke: fold_fma not launched in every leg of {BENCH_FOLD_LEGS}")
    return {"s": wall, "record": record, "launches": launches, "flash_launches": flash, "fold_launches": folds,
            "norm_launches": norms, "misses": misses, "leg_s": {leg: st["s"] for leg, st in stats.items()}}


# -- bench_torch.py --compute-only: the reference bench's compute section ------

# Flash launches a train step makes, as the code gives them: llama_train's
# remat_policy="dots" keeps the weight products and replays the rest of each
# layer in the backward, attention included (the forward twice a layer), and
# lora_8b's full remat replays the whole layer; dQ and dK/dV run once a layer.
BENCH_TRAIN_LAYERS = {"llama_train": 16, "lora_8b": 32}
# Legs whose path launches the flash forward (decode: the prefills), and
# those that launch the backward kernels too.
BENCH_FWD_LEGS = ("llama_train", "decode", "flash", "lora_8b")
BENCH_BWD_LEGS = ("llama_train", "flash", "lora_8b")
BENCH_NORM_LEGS = ("llama_train", "decode", "lora_8b")  # the legs that run a Llama
# A share over 1 is a count error, not a fast card.
BENCH_SHARE_MAX = 1.05
# The breakdown's residual, the step less its six probes, which the
# reference clamps at 0: the probes are timed alone and account for all but
# 0-45 ms of the ~210-390 ms step (PERF.md), so a step timed a little fast
# leaves 0.  It is held to finite and at least 0; every probe stays > 0.
BENCH_CLAMPED = ("llama_other_ms",)
# Repetition counts this script passes to the legs, cut to fit the script's
# time limit (bench_torch.py --compute-only keeps the reference's: 333 s of
# legs on an H100 80GB HBM3 at 700 W, PERF.md); widths, batches, sequence
# lengths and shapes stay the reference's, and every n_long is at least
# n_short + 4.
BENCH_COMPUTE_KW = {
    "llama_train": dict(n_long=6, probe_n={"attn": (8, 128), "matmul": (4, 32), "head": (4, 16), "adam": (4, 8),
                                           "norms_rope": (4, 32), "remat": (4, 32)}),
    "decode": dict(n_long=24, n_long_long=24, reps=1),
    "flash": dict(n_long=16, n_long_t4096=12, reps=1),
    "lora_8b": dict(decode_long=24, reps=1),
}


def _train_step_launches(layers):
    return {"flash_fwd": 2 * layers, "flash_bwd_dq": layers, "flash_bwd_dkv": layers}


def phase_bench_compute(device=None):
    """``bench_torch.run_compute``: the five legs of ``bench.py
    --compute-only`` in this process (the ~1.07B Llama's Adam step and its
    MFU breakdown, its decode, flash vs dense attention, Llama-3-8B's int8
    LoRA step and decode, MoE dispatch), with ``BENCH_COMPUTE_KW``'s counts.
    Fatal: a leg's error; a non-finite or non-positive value (a negative
    one for the clamped residual of ``BENCH_CLAMPED``); ``llama_mfu``
    or a ``*_membw_util`` over ``BENCH_SHARE_MAX``; no flash forward launch
    in a leg of BENCH_FWD_LEGS, no dQ or dK/dV launch in one of
    BENCH_BWD_LEGS; a train leg's launches other than
    ``_train_step_launches`` a step.  ``device="cpu"`` rehearses it (the
    launch checks expect 0).  The record and each leg's stats are written to
    chiprun_out/bench_compute.json."""
    import bench_torch

    dev = "cuda" if device is None else device
    on_card = dev != "cpu"
    t0 = time.perf_counter()
    stats = {}
    record = bench_torch.run_compute(dev, stats, leg_kw=BENCH_COMPUTE_KW)
    wall = time.perf_counter() - t0
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "bench_compute.json"), "w") as f:
        json.dump({"record": record, "stats": stats, "leg_kw": BENCH_COMPUTE_KW}, f, indent=1, default=repr)
    for leg, st in stats.items():
        peak = "n/a" if st["peak_bytes"] is None else f"{st['peak_bytes'] / 1e9:.2f} GB"
        flash = {k: v for k, v in st["launches"].items() if k.startswith("flash_")}
        print(f"[bench_compute] {leg}: {st['s']:.1f} s, flash launches {flash}, peak {peak}")
    for key, value in record.items():
        print(f"[bench_compute] {key}: {value!r}")
    failures = [f"{k}: {record[k]}" for k in record if k.endswith("_error")]
    for key, value in record.items():
        if key.endswith("_error") or key.startswith("env_") or key in ("metric", "unit", "vs_baseline"):
            continue
        if key in BENCH_CLAMPED:
            if not (isinstance(value, (int, float)) and math.isfinite(value) and value >= 0):
                failures.append(f"{key}={value!r} is not finite and at least 0")
        elif not (isinstance(value, (int, float)) and math.isfinite(value) and value > 0):
            failures.append(f"{key}={value!r} is not finite and positive")
        elif (key == "llama_mfu" or key.endswith("_membw_util")) and value > BENCH_SHARE_MAX:
            failures.append(f"{key}={value} over {BENCH_SHARE_MAX}: a count error")
    expect = 1 if on_card else 0
    for leg, st in stats.items():
        got = st["launches"]
        if leg in BENCH_FWD_LEGS and (got["flash_fwd"] > 0) != bool(expect):
            failures.append(f"{leg}: flash forward launches {got['flash_fwd']}")
        if leg in BENCH_BWD_LEGS and any((got[k] > 0) != bool(expect) for k in ("flash_bwd_dq", "flash_bwd_dkv")):
            failures.append(f"{leg}: backward launches {got}")
        if leg in BENCH_TRAIN_LAYERS:
            want = {k: n * st["train_steps"] * expect
                    for k, n in _train_step_launches(BENCH_TRAIN_LAYERS[leg]).items()}
            print(f"[bench_compute] {leg}: {st['train_steps']} train steps launched {st['train_launches']} "
                  f"(want {want})")
            if st["train_launches"] != want:
                failures.append(f"{leg}: train steps launched {st['train_launches']}, want {want}")
        norms = {k: got.get(f"rms_norm_{k}", 0) for k in ("fwd", "bwd", "dscale")}
        # The Llama legs' norms on the kernels; the full-parameter step's
        # scales train, so its backward reduces dscale too.
        if leg in BENCH_NORM_LEGS and (norms["fwd"] > 0) != bool(expect):
            failures.append(f"{leg}: RMSNorm launches {norms}")
        if leg == "llama_train" and (norms["dscale"] > 0) != bool(expect):
            failures.append(f"{leg}: the full-parameter step's dscale launches {norms['dscale']}")
    launches = {k: sum(st["launches"].get(k, 0) for st in stats.values())
                for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "fold_fma", "rms_norm_fwd", "rms_norm_bwd",
                          "rms_norm_dscale")}
    print(f"[bench_compute] five legs on {dev} in {wall:.1f} s; launches {launches}")
    if failures:
        raise AssertionError("phase_bench_compute: " + "; ".join(failures))
    return {"s": wall, "record": record, "stats": stats, "launches": launches}


# -- bench_torch.py --fed-only: the reference bench's federated section -------

# Legs whose parties fold floats on the card (the packed ResNet-18 rounds);
# the others move tensors, or average plain trees (lora_2party,
# fedavg_mnist: fl.aggregate's leaf means), and launch no fold.
BENCH_FED_FOLD_LEGS = ("stream_agg", "ring_agg", "overlap", "resnet_fedavg")
# Repetition counts this script passes to the legs, cut to fit its time limit
# (bench_torch.py --fed-only keeps the reference's; the eleven legs took
# 279.1 s one after another, PERF.md): split learning's best of 1 window
# (3), the push bench's best of 2 windows (3) of 3 pushes (6) and 2 onto the
# card (4); widths, batches, tensors, bundles and round counts stay the
# reference's.  Two legs run at a time (BENCH_FED_LANES), as the smoke
# legs do, with 1 s (3 s) of settle after each.
BENCH_FED_KW = {"split_fl": {"windows": 1}, "push_bench": {"reps": 2, "steps": 3, "reshard_steps": 2}}
BENCH_FED_SETTLE_S = 1.0
BENCH_FED_LANES = 2
# Timed keys (ms, s, GB/s, a rate) must be > 0; this one is the step less its
# read and send sessions, clamped at 0 as the reference clamps it.
BENCH_FED_CLAMPED = ("split_fl_other_ms",)


def _bench_fed_sizes():
    """The federated legs' size-fixed keys, from the port's own sizes: the
    packed bf16 ResNet-18 bundle's MB and the LoRA leg's adapters' MB."""
    import bench_torch
    from rayfed_tpu_torch import tree_util
    from rayfed_tpu_torch.models import resnet

    cpu = torch.device("cpu")
    bundle = fl.compression.compress(
        resnet.init_resnet(torch.Generator().manual_seed(0), resnet.resnet18(num_classes=10), device=cpu), packed=True)
    bundle_mb = round(bundle.buf.numel() * bundle.buf.element_size() / 1e6, 1)
    cfg = llama.LlamaConfig(**bench_torch.LORA_CONFIG)
    base = llama.init_llama(cfg, torch.Generator().manual_seed(42), device=cpu)
    adapters = lora.init_lora(base, lora.LoraConfig(rank=8, targets=(r"w[qv]$", r"lm_head$")),
                              torch.Generator().manual_seed(7), device=cpu)
    adapter_mb = sum(t.numel() * t.element_size() for t in tree_util.tree_leaves(adapters)) / 1e6
    return {"stream_agg_bundle_mb": bundle_mb, "ring_bundle_mb": bundle_mb,
            "lora_adapter_MB_per_push": round(adapter_mb, 3)}


def _bench_fed_timed(key: str) -> bool:
    return "_ms" in key or key.endswith("_s") or key.endswith("GBps") or "per_sec" in key


def phase_bench_fed(device=None):
    """``bench_torch.run_fed``: the federated section of ``bench.py`` (its
    first half without a mode flag) on the port, every leg in its spawned
    processes with every party's compute on the card: the 1F1B and
    interleaved pipelines against DP over a 4-rank gloo world, split
    learning's activation push, the raw push of a 128 MB tensor from the
    card, the send-path, streaming, ring and overlap legs at their full
    (ResNet-18) sizes, the 2-party Llama-LoRA fine-tune, 4-party ResNet-18
    FedAvg with its floor and the DP control, and the headline 2-party
    FedAvg.  Cut to fit the script's limit, widths untouched: split
    learning's best of 1 window (the reference's 3), the push bench's best of
    2 windows (3) of 3 pushes (6) and of 2 onto the card (4)
    (``BENCH_FED_KW``), 1 s of settle after each leg (3 s,
    ``BENCH_FED_SETTLE_S``), and two legs at a time (``BENCH_FED_LANES``: the
    walls of two legs then share the host and the card).  Fatal: a leg's error; a missing key of the reference's
    section; a value that is not finite, a timed one (ms, s, GB/s, a rate)
    that is not > 0 (``BENCH_FED_CLAMPED`` at least 0), any other number
    below 0; a size-fixed key other than the port's own sizes give
    (``_bench_fed_sizes``); a flash launch (the LoRA leg's attention is
    dense); no fold_fma launch in a leg of BENCH_FED_FOLD_LEGS; JAX loaded
    here (every child asserts it loaded none before it reports).  Prints
    each leg's wall, launches and peak device memory.  ``device="cpu"``
    rehearses it (no launch expected).  The record and the stats are written
    to chiprun_out/bench_fed.json."""
    import bench_torch

    dev = "cuda" if device is None else device
    on_card = dev != "cpu"
    t0 = time.perf_counter()
    stats = {}
    record = bench_torch.run_fed(dev, stats=stats, leg_kw=BENCH_FED_KW, settle_s=BENCH_FED_SETTLE_S,
                                 lanes=BENCH_FED_LANES)
    wall = time.perf_counter() - t0
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "bench_fed.json"), "w") as f:
        json.dump({"record": record, "stats": stats, "leg_kw": BENCH_FED_KW}, f, indent=1, default=repr)
    for leg, st in stats.items():
        peak = "n/a" if st["peak_bytes"] is None else f"{st['peak_bytes'] / 1e9:.3f} GB"
        print(f"[bench_fed] {leg}: {st['s']:.1f} s, launches {st['launches']}, peak device memory {peak}")
    for key, value in record.items():
        print(f"[bench_fed] {key}: {value!r}")
    failures = [f"{k}: {record[k]}" for k in record if k.endswith("_error")]
    want = [k for leg in bench_torch.FED_LEG_NAMES for k in bench_torch.FED_KEYS[leg]] + list(bench_torch.ENV_KEYS)
    if record.get("resnet_fedavg_vs_dp_ratio", 1.0) < 0.9:
        want += bench_torch.FED_PRED_KEYS
    failures += [f"{k} missing" for k in want if k not in record]
    for key, value in record.items():
        if key.endswith("_error") or key.startswith("env_") or key in ("metric", "unit") \
                or isinstance(value, (str, dict)):
            continue
        if not (isinstance(value, (int, float)) and math.isfinite(value)):
            failures.append(f"{key}={value!r} is not finite")
        elif _bench_fed_timed(key) and key not in BENCH_FED_CLAMPED and value <= 0:
            failures.append(f"{key}={value!r} is not > 0")
        elif value < 0:
            failures.append(f"{key}={value!r} is below 0")
    for key, value in _bench_fed_sizes().items():
        if record.get(key) != value:
            failures.append(f"{key}={record.get(key)!r}, the port's sizes give {value!r}")
    if record.get("metric") != bench_torch.HEADLINE or record.get("env_device_kind") != bench_torch._device_kind(dev):
        failures.append(f"headline {record.get('metric')!r} on {record.get('env_device_kind')!r}")
    launches = {leg: st["launches"] for leg, st in stats.items()}
    flash = {k: sum(n.get(f"flash_{k}", 0) for n in launches.values()) for k in ("fwd", "bwd_dq", "bwd_dkv")}
    norms = _bench_norms(launches)
    folds = {leg: n.get("fold_fma", 0) for leg, n in launches.items()}
    if any(flash.values()):
        failures.append(f"flash kernels launched {flash}")
    if on_card and not all(folds.get(leg, 0) for leg in BENCH_FED_FOLD_LEGS):
        failures.append(f"fold_fma not launched in every leg of {BENCH_FED_FOLD_LEGS}: {folds}")
    if not on_card and any(folds.values()):
        failures.append(f"fold_fma launched off the card: {folds}")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "rayfed_tpu"))
    if loaded:
        failures.append(f"this process loaded {loaded}")
    if not on_card and any(norms.values()):
        failures.append(f"RMSNorm kernels launched off the card: {norms}")
    print(f"[bench_fed] {len(stats)} legs on {dev} in {wall:.1f} s; fold_fma by leg {folds}, flash {flash}, "
          f"norms {norms}")
    if failures:
        raise AssertionError("phase_bench_fed: " + "; ".join(failures))
    return {"s": wall, "record": record, "stats": stats, "flash_launches": flash, "norm_launches": norms,
            "fold_launches": sum(folds.values()), "folds_by_leg": folds}


def _timed(walls, fn, *args, **kw):
    """Run one phase and print its wall."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    walls[fn.__name__] = time.perf_counter() - t0
    print(f"[wall] {fn.__name__}: {walls[fn.__name__]:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    print(f"[card] {card}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    suite = _secagg_suite()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    walls, t_start = {}, time.perf_counter()

    _timed(walls, phase_build)
    slice_err = _timed(walls, phase_kernel_vs_plain, gen)
    bwd_err = _timed(walls, phase_bwd_kernel_vs_plain, gen)
    _zero_counts()
    serve = _timed(walls, phase_slice, gen)
    serve_launches = serve["launches"]
    train = _timed(walls, phase_train, gen)
    _timed(walls, phase_grad_check, gen)
    serve_int8 = _timed(walls, phase_serve_int8, gen, serve)
    train_int8 = _timed(walls, phase_train_int8, gen, train)
    fold_times = _timed(walls, phase_fold, gen, card)
    sopt = _timed(walls, phase_server_opt, card)
    ckpt_root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    federated = _timed(walls, phase_federated, ckpt_root)
    round_launches = federated["round"]["launches"]
    quant_launches = federated["round_quant"]["launches"]
    round_fold = federated["round"]["fold_launches"]
    quant_fold = federated["round_quant"]["fold_launches"]
    split = _timed(walls, phase_split)
    split_launches = split["launches"]
    topo = _timed(walls, phase_topologies)
    topo_fold, topo_flash = topo["fold_launches"], topo["flash_launches"]
    hier_ml = _timed(walls, phase_hierarchy_multilevel, topo["elements"])
    ml_launches = {k: v for k, v in hier_ml["round1"]["launches"].items()}
    for k, v in hier_ml["round2"]["launches"].items():
        ml_launches[k] += v
    asyn = _timed(walls, phase_async, card)
    _timed(walls, phase_secagg, card, suite, topo, federated)
    ckpt = _timed(walls, phase_checkpoint, federated, ckpt_root)
    shutil.rmtree(ckpt_root, ignore_errors=True)
    par = _timed(walls, phase_parallel)
    par_launches = par["launches"]
    pipe = _timed(walls, phase_pipeline)
    party = _timed(walls, phase_party_processes)
    examples = _timed(walls, phase_examples)
    # The smoke and federated legs are spawned children bound by the host:
    # the two phases run at once, each with its own children, counts and
    # checks (their walls share the host's cores and the card).
    with ThreadPoolExecutor(1) as pool:
        fed_run = pool.submit(_timed, walls, phase_bench_fed)
        bench = _timed(walls, phase_bench_smoke)
        bench_f = fed_run.result()
    bench_c = _timed(walls, phase_bench_compute)
    ckpt_llama, ckpt_resnet = ckpt["llama"]["launches"], ckpt["quorum"]["flash_launches"]
    overlap = {k: sum(federated[part]["launches"][k] for part in OVERLAP_PARTS) for k in COUNT_KEYS}
    overlap_fold = sum(federated[part]["fold_launches"] for part in OVERLAP_PARTS)
    ring_launches = federated["round_ring"]["launches"]
    ring_fold = federated["round_ring"]["fold_launches"]
    sopt_llama = {k: sum(federated[part]["launches"][k] for part in SOPT_PARTS) for k in COUNT_KEYS}
    sopt_llama_fold = sum(federated[part]["fold_launches"] for part in SOPT_PARTS)
    sopt_resnet = {k: sum(topo_flash[n][k] for n, _ in SOPT_TOPO_PARTS) for k in ("fwd", "bwd_dq", "bwd_dkv")}
    sopt_resnet_fold = sum(topo_fold[n] for n, _ in SOPT_TOPO_PARTS)
    async_launches = asyn["launches"]
    _timed(walls, phase_split_grads, gen)
    _timed(walls, phase_hf, gen)
    times, train_times = _timed(walls, phase_times, gen, card)
    bwd_times = _timed(walls, phase_bwd_times, gen, card)
    bert_times = _timed(walls, phase_bert_times, gen, card)
    rms_times = _timed(walls, phase_rms_norm, gen, card)
    # The server step's share of a server-opt round: its device ms at the
    # adapters' size against alice's wall per round.
    step_rec = sopt["step"][("llama_adapters",) + SOPT_CONFIGS[1]]
    round_s = federated["round_server_opt"]["per_round_s"]["alice"]
    print(f"[server_opt] the step's device time at the adapters' size, {step_rec['ms']:.4f} ms "
          f"({step_rec['launches']} fold_fma launches) + resync {step_rec['resync_ms']:.4f} ms, is "
          f"{(step_rec['ms'] + step_rec['resync_ms']) / 1e3 / round_s:.2e} of alice's {round_s:.3f} s server-opt round")
    print(f"[wall] all phases: {time.perf_counter() - t_start:.1f} s")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip())
    def norms_by_path(key):
        """The RMSNorm kernels' ``key`` launches on every path, read as the
        flash kernels' are (0 where a path runs no Llama)."""
        return {"serve": serve["norms"][key], "train": train_launches[key],
                "federated": federated["launches"][key], "round": round_launches[key],
                "serve_int8": serve_int8["norms"][key], "train_int8": train_int8["launches"][key],
                "round_quant": quant_launches[key], "split": split_launches[key],
                "round_ring": ring_launches[key],
                "ring_resnet": topo_flash["ring"].get(key, 0) + topo_flash["ring_quant"].get(key, 0),
                "quorum_resnet": topo_flash["quorum"].get(key, 0),
                "hierarchy_resnet": sum(topo_flash[n].get(key, 0) for n in HIER_PARTS),
                "hier_multilevel": ml_launches.get(key, 0), "round_overlap": overlap[key],
                "server_opt_llama": sopt_llama[key],
                "server_opt_resnet": sum(topo_flash[n].get(key, 0) for n, _ in SOPT_TOPO_PARTS),
                "async_resnet": async_launches.get(key, 0), "checkpoint_llama": ckpt_llama[key],
                "checkpoint_resnet": ckpt_resnet.get(key, 0),
                **{path: par_launches[path][key] for path in PAR_PATHS},
                **{path: pipe["launches"][path][key] for path in PIPE_PATHS},
                "party_resnet": party["flash_launches"].get(key, 0),
                "examples": examples["norm_launches"][key], "bench_smoke": bench["norm_launches"][key],
                "bench_compute": bench_c["launches"][f"rms_norm_{key[5:]}"],
                "bench_fed": bench_f["norm_launches"][key]}

    # `launches`: the training path's 4 steps; the serving path's count of
    # the forward kernel stands beside it.
    train_launches = train["launches"]
    bwd_src = "rayfed_tpu_torch/ops/csrc/flash_bwd.cu"
    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "rayfed_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "rayfed_tpu/ops/flash_attention.py:84",
        "launches": train_launches["fwd"],
        "launches_by_path": {"serve": serve_launches, "train": train_launches["fwd"],
                             "federated": federated["launches"]["fwd"],
                             "round": round_launches["fwd"],
                             "serve_int8": serve_int8["launches"],
                             "train_int8": train_int8["launches"]["fwd"],
                             "round_quant": quant_launches["fwd"],
                             "split": split_launches["fwd"],
                             "round_ring": ring_launches["fwd"],
                             "ring_resnet": topo_flash["ring"]["fwd"] + topo_flash["ring_quant"]["fwd"],
                             "quorum_resnet": topo_flash["quorum"]["fwd"],
                             "hierarchy_resnet": sum(topo_flash[n]["fwd"] for n in HIER_PARTS),
                             "hier_multilevel": ml_launches["fwd"],
                             "round_overlap": overlap["fwd"],
                             "server_opt_llama": sopt_llama["fwd"],
                             "server_opt_resnet": sopt_resnet["fwd"],
                             "async_resnet": async_launches["fwd"],
                             "checkpoint_llama": ckpt_llama["fwd"],
                             "checkpoint_resnet": ckpt_resnet["fwd"],
                             # phase_parallel, every rank: the ring, zigzag and Ulysses
                             # ops at the Llama shape, the sp=2 Llama-3-8B prefill and
                             # LoRA step, the TP/FSDP forward
                             **{path: par_launches[path]["fwd"] for path in PAR_PATHS},
                             # phase_pipeline, every rank: GPipe's forward, a 1F1B step,
                             # an interleaved step; phase_party_processes (ResNet-18)
                             **{path: pipe["launches"][path]["fwd"] for path in PIPE_PATHS},
                             "party_resnet": party["flash_launches"]["fwd"],
                             # phase_examples: every process of the seven examples
                             "examples": examples["flash_launches"]["fwd"],
                             # phase_bench_smoke: every child of the twelve legs
                             "bench_smoke": bench["flash_launches"]["fwd"],
                             # phase_bench_compute: the five legs, this process
                             "bench_compute": bench_c["launches"]["flash_fwd"],
                             # phase_bench_fed: every child and rank of its legs
                             "bench_fed": bench_f["flash_launches"]["fwd"]},
        "bert_shape": bert_times["fwd"],  # bert_base's attention on the split path
        "max_abs_err": slice_err,
        **times,
        "train_shape": train_times,  # B=1: the shape the train step launches it at
    }, {
        "name": "flash_bwd_dq",
        "route": "cuda",
        "source": bwd_src,
        "replaces": "rayfed_tpu/ops/flash_attention.py:253",
        "launches": train_launches["bwd_dq"],
        "launches_by_path": {"serve": 0, "train": train_launches["bwd_dq"],
                             "federated": federated["launches"]["bwd_dq"],
                             "round": round_launches["bwd_dq"],
                             "serve_int8": 0, "train_int8": train_int8["launches"]["bwd_dq"],
                             "round_quant": quant_launches["bwd_dq"],
                             "split": split_launches["bwd_dq"],
                             "round_ring": ring_launches["bwd_dq"],
                             "ring_resnet": topo_flash["ring"]["bwd_dq"] + topo_flash["ring_quant"]["bwd_dq"],
                             "quorum_resnet": topo_flash["quorum"]["bwd_dq"],
                             "hierarchy_resnet": sum(topo_flash[n]["bwd_dq"] for n in HIER_PARTS),
                             "hier_multilevel": ml_launches["bwd_dq"],
                             "round_overlap": overlap["bwd_dq"],
                             "server_opt_llama": sopt_llama["bwd_dq"],
                             "server_opt_resnet": sopt_resnet["bwd_dq"],
                             "async_resnet": async_launches["bwd_dq"],
                             "checkpoint_llama": ckpt_llama["bwd_dq"],
                             "checkpoint_resnet": ckpt_resnet["bwd_dq"],
                             # phase_parallel, every rank: the ring, zigzag and Ulysses
                             # ops at the Llama shape, the sp=2 Llama-3-8B prefill and
                             # LoRA step, the TP/FSDP forward
                             **{path: par_launches[path]["bwd_dq"] for path in PAR_PATHS},
                             # phase_pipeline, every rank: GPipe's forward, a 1F1B step,
                             # an interleaved step; phase_party_processes (ResNet-18)
                             **{path: pipe["launches"][path]["bwd_dq"] for path in PIPE_PATHS},
                             "party_resnet": party["flash_launches"]["bwd_dq"],
                             # phase_examples: every process of the seven examples
                             "examples": examples["flash_launches"]["bwd_dq"],
                             # phase_bench_smoke: every child of the twelve legs
                             "bench_smoke": bench["flash_launches"]["bwd_dq"],
                             # phase_bench_compute: the five legs, this process
                             "bench_compute": bench_c["launches"]["flash_bwd_dq"],
                             # phase_bench_fed: every child and rank of its legs
                             "bench_fed": bench_f["flash_launches"]["bwd_dq"]},
        "bert_shape": bert_times["dq"],  # bert_base's attention on the split path
        "max_abs_err": bwd_err["dq"],
        **bwd_times["dq"],
    }, {
        "name": "flash_bwd_dkv",
        "route": "cuda",
        "source": bwd_src,
        "replaces": "rayfed_tpu/ops/flash_attention.py:325",
        "launches": train_launches["bwd_dkv"],
        "launches_by_path": {"serve": 0, "train": train_launches["bwd_dkv"],
                             "federated": federated["launches"]["bwd_dkv"],
                             "round": round_launches["bwd_dkv"],
                             "serve_int8": 0, "train_int8": train_int8["launches"]["bwd_dkv"],
                             "round_quant": quant_launches["bwd_dkv"],
                             "split": split_launches["bwd_dkv"],
                             "round_ring": ring_launches["bwd_dkv"],
                             "ring_resnet": topo_flash["ring"]["bwd_dkv"] + topo_flash["ring_quant"]["bwd_dkv"],
                             "quorum_resnet": topo_flash["quorum"]["bwd_dkv"],
                             "hierarchy_resnet": sum(topo_flash[n]["bwd_dkv"] for n in HIER_PARTS),
                             "hier_multilevel": ml_launches["bwd_dkv"],
                             "round_overlap": overlap["bwd_dkv"],
                             "server_opt_llama": sopt_llama["bwd_dkv"],
                             "server_opt_resnet": sopt_resnet["bwd_dkv"],
                             "async_resnet": async_launches["bwd_dkv"],
                             "checkpoint_llama": ckpt_llama["bwd_dkv"],
                             "checkpoint_resnet": ckpt_resnet["bwd_dkv"],
                             # phase_parallel, every rank: the ring, zigzag and Ulysses
                             # ops at the Llama shape, the sp=2 Llama-3-8B prefill and
                             # LoRA step, the TP/FSDP forward
                             **{path: par_launches[path]["bwd_dkv"] for path in PAR_PATHS},
                             # phase_pipeline, every rank: GPipe's forward, a 1F1B step,
                             # an interleaved step; phase_party_processes (ResNet-18)
                             **{path: pipe["launches"][path]["bwd_dkv"] for path in PIPE_PATHS},
                             "party_resnet": party["flash_launches"]["bwd_dkv"],
                             # phase_examples: every process of the seven examples
                             "examples": examples["flash_launches"]["bwd_dkv"],
                             # phase_bench_smoke: every child of the twelve legs
                             "bench_smoke": bench["flash_launches"]["bwd_dkv"],
                             # phase_bench_compute: the five legs, this process
                             "bench_compute": bench_c["launches"]["flash_bwd_dkv"],
                             # phase_bench_fed: every child and rank of its legs
                             "bench_fed": bench_f["flash_launches"]["bwd_dkv"]},
        "bert_shape": bert_times["dkv"],  # bert_base's attention on the split path
        "max_abs_err": bwd_err["dkv"],
        **bwd_times["dkv"],
    }, {
        # Not a Pallas kernel: the JAX package's jitted float fold step, which
        # XLA compiles into fused multiply-adds (the one-shot chain,
        # rayfed_tpu/fl/fedavg.py:83, is the same kernel's other form).
        "name": "fold_fma",
        "route": "cuda",
        "source": "rayfed_tpu_torch/ops/csrc/fold_fma.cu",
        "replaces": "rayfed_tpu/fl/streaming.py:63",
        "launches": round_fold,
        "launches_by_path": {"serve": 0, "train": 0, "federated": 0, "round": round_fold,
                             "serve_int8": 0, "train_int8": 0, "round_quant": quant_fold, "split": 0,
                             "round_ring": ring_fold,
                             # every party's folds: the 4 stripe owners of the ring
                             # (bf16 and the quantized ring's bootstrap round), the
                             # quorum coordinators (alice, then bob after the failover)
                             "ring_resnet": topo_fold["ring"] + topo_fold["ring_quant"],
                             "quorum_resnet": topo_fold["quorum"],
                             # the hierarchy folds integers; its float folds are the
                             # flat bootstrap rounds' (and the flat quantized hub's)
                             "hierarchy_resnet": sum(topo_fold[n] for n in HIER_PARTS),
                             "hier_multilevel": ml_launches["fold_fma"],
                             "round_overlap": overlap_fold,
                             # the server step and resync (rayfed_tpu/fl/fedavg.py:365, :433)
                             # on the card, both parties' rounds
                             "server_opt_llama": sopt_llama_fold,
                             "server_opt_resnet": sopt_resnet_fold,
                             "async_resnet": async_launches["fold_fma"],
                             # both parties' folds, steps and resyncs over the three
                             # checkpointed Llama runs; the four ResNet-18 parties'
                             # over the uninterrupted and the resumed quorum runs
                             "checkpoint_llama": ckpt["llama"]["fold_launches"],
                             "checkpoint_resnet": ckpt["quorum"]["fold_launches"],
                             # phase_parallel's paths, every rank (read as the flash kernels' are)
                             **{path: par["fold_launches"][path] for path in PAR_PATHS},
                             **{path: pipe["fold_launches"][path] for path in PIPE_PATHS},
                             # every process's folds over both rounds (bob, the coordinator)
                             "party_resnet": party["fold_launches"],
                             # every process of the seven examples: none packs a contribution
                             "examples": examples["fold_launches"],
                             # every child of bench_torch.py --smoke's legs: the
                             # float folds, the server step and resync
                             "bench_smoke": bench["fold_launches"],
                             # the compute legs pack no contribution
                             "bench_compute": bench_c["launches"]["fold_fma"],
                             # every child of bench_torch.py --fed-only's legs: the
                             # packed ResNet-18 rounds' folds and finalizes
                             "bench_fed": bench_f["fold_launches"]},
        # Its forms: the streamed step (one launch a run of blocks), the
        # pair (the server step), the chain (the whole one-shot fold and its
        # finalize, up to fold.MAX_OPS operands a launch), the finalize (a
        # streamed or striped fold's divide and cast), the rows (the
        # codec's two FMAs) and ftz (the round's flushed add, subtract,
        # multiply and divide); launches by form in alice's round parts.
        "forms": ["step", "pair", "chain", "finalize", "rows", "ftz"],
        "launches_by_form": federated["fold_by_form"],
        **fold_times["adapters"],  # one contribution of the round's packed adapters
        "wq_shape": fold_times["wq"],
        # The codec on the rows form (rayfed_tpu/fl/quantize.py:473, :507).
        "codec": fold_times["codec"],
        # The same kernel as the server step's fused multiply-adds: FedAC at
        # the adapters' size, against the step's plain version (ops/fold.py
        # fma_ftz on the card) and its bytes (x, avg and z read, x' written).
        "server_step": {"replaces": "rayfed_tpu/fl/fedavg.py:365", "launches": step_rec["launches"],
                        "ms": step_rec["ms"], "plain_ms": step_rec["plain_ms"], "bound_ms": step_rec["bound_ms"],
                        "bound_by": "bytes", "library_ms": None, "max_abs_err": 0.0,
                        "resync_ms": step_rec["resync_ms"], "resync_bound_ms": step_rec["resync_bound_ms"]},
    }] + [{
        # Not Pallas: the JAX package's norm is jnp ops that XLA fuses; on
        # the card a forward and a backward kernel replace PyTorch's passes.
        # Launches: phase_train's 4 LoRA steps (remat); times at Mistral's shape.
        "name": f"rms_norm_{name}",
        "route": "cuda",
        "source": "rayfed_tpu_torch/ops/csrc/rms_norm.cu",
        "replaces": "rayfed_tpu/models/llama.py _rms_norm (XLA-fused jnp ops)",
        "launches": train_launches[f"norm_{name}"],
        "launches_by_path": norms_by_path(f"norm_{name}"),
        # The backward's second kernel, the reduce of dscale's partials,
        # where a norm's scale trains (full-parameter steps, pipeline stages).
        **({"dscale_launches_by_path": norms_by_path("norm_dscale")} if name == "bwd" else {}),
        **rms_times[name],
    } for name in ("fwd", "bwd")]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
