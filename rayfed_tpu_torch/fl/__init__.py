"""Federated-learning algorithms built on the fed API.

The port of the JAX package's fl package:

- :mod:`compression` — the per-leaf and packed wire forms
  (:class:`PackedTree`, byte-compatible with the JAX package's) and error
  feedback.
- :mod:`fedavg` — weighted parameter averaging, the one-shot packed
  folds (float and integer codes) and :func:`aggregate`.
- :mod:`quantize` — the compressed-domain codec: the shared per-round
  grid, :class:`QuantizedPackedTree` (byte-compatible with the JAX
  package's) and the error-feedback compressor.
- :mod:`streaming` — the streaming on-card fold and
  :func:`streaming_aggregate`, its quorum cutoff and the ring's
  :class:`StripeAggregator`.
- :mod:`ring` — :func:`ring_aggregate`, the chunk-striped ring round.
- :mod:`hierarchy` — :func:`hierarchy_aggregate`, the multi-level region
  tree of integer partial sums (``run_fedavg_rounds(mode="hierarchy")``),
  with :class:`RegionSumTree`, its wire form.
- :mod:`quorum` — k-of-n rounds, elastic membership and coordinator
  failover (``run_fedavg_rounds(quorum=...)``, ``fed.join``/``fed.leave``).
- :mod:`overlap` — :class:`PipelinedRoundRunner`, rounds whose
  aggregation runs under the next round's compute
  (``run_fedavg_rounds(overlap=True)``), and :func:`dga_correct`, its
  staleness correction and the late fold of a straggler.
- :mod:`async_rounds` — buffered asynchronous rounds with exact integer
  staleness decay (:class:`AsyncBuffer`, :func:`run_async_fleet`).
- :mod:`server_opt` — the packed server optimizers (server momentum,
  FedAC), stepped where a round finalizes.
- :mod:`fedopt` — the legacy server optimizers and FedProx.
- :mod:`trainer` — :func:`run_fedavg_rounds`, the round loop.
- :mod:`split` — :class:`SplitTrainer`, split (vertical) learning across
  two parties.
- :mod:`secagg` — secure aggregation: pairwise-masked integer folds with
  quorum-dropout mask recovery (``run_fedavg_rounds(secure_agg=True)``),
  and the seed-era in-process primitives (:mod:`secure` is their
  deprecated shim).
- :mod:`dp` — differential privacy: global-norm clipping and Gaussian
  noise on outgoing updates.
- :mod:`robust` — Byzantine-robust aggregation (coordinate median, trimmed
  mean, Krum/multi-Krum) bounding any single party's influence.
"""

from rayfed_tpu_torch.fl.compression import (
    ErrorFeedback,
    PackedTree,
    PackSpec,
    compress,
    decompress,
    pack_tree,
    unpack_tree,
)
from rayfed_tpu_torch.fl.dp import clip_by_global_norm, privatize
from rayfed_tpu_torch.fl.fedavg import (
    FedAvgActorBase,
    aggregate,
    packed_quantized_sum,
    packed_weighted_sum,
    tree_average,
    tree_weighted_sum,
)
from rayfed_tpu_torch.fl.fedopt import (
    ServerOptimizer,
    fedprox_loss,
    server_adam,
    server_sgd,
    server_yogi,
)
from rayfed_tpu_torch.fl.quantize import (
    QuantCompressor,
    QuantGrid,
    QuantizedPackedTree,
    dequantize_packed,
    make_round_grid,
    quantize_packed,
)
from rayfed_tpu_torch.fl.hierarchy import HierarchyRoundError, RegionSumTree, hierarchy_aggregate
from rayfed_tpu_torch.fl.overlap import PipelinedRoundRunner, dga_correct
from rayfed_tpu_torch.fl.async_rounds import (
    AsyncBuffer,
    bootstrap_grid,
    decay_weight,
    run_async_coordinator,
    run_async_fleet,
    run_async_party,
)
from rayfed_tpu_torch.fl.quorum import QuorumRoundError, quorum_aggregate, run_quorum_rounds
from rayfed_tpu_torch.fl.ring import RingRoundError, ring_aggregate
from rayfed_tpu_torch.fl.streaming import StreamingAggregator, StripeAggregator, streaming_aggregate
from rayfed_tpu_torch.fl.server_opt import (
    PackedServerOpt,
    PackedServerOptimizer,
    PackedServerState,
    fedac,
    server_momentum,
)
from rayfed_tpu_torch.fl.robust import krum, multi_krum, tree_median, tree_trimmed_mean
from rayfed_tpu_torch.fl.secagg import (
    MaskedCodeTree,
    MaskedRoundCodec,
    RoundMasker,
    SecAggError,
    mask_update,
    unmask_sum,
)
from rayfed_tpu_torch.fl.split import SplitTrainer
from rayfed_tpu_torch.fl.trainer import run_fedavg_rounds, validate_round_config

__all__ = [
    "aggregate",
    "packed_weighted_sum",
    "packed_quantized_sum",
    "QuantCompressor",
    "QuantGrid",
    "QuantizedPackedTree",
    "dequantize_packed",
    "make_round_grid",
    "quantize_packed",
    "streaming_aggregate",
    "StreamingAggregator",
    "StripeAggregator",
    "ring_aggregate",
    "RingRoundError",
    "QuorumRoundError",
    "quorum_aggregate",
    "run_quorum_rounds",
    "hierarchy_aggregate",
    "HierarchyRoundError",
    "RegionSumTree",
    "PipelinedRoundRunner",
    "dga_correct",
    "AsyncBuffer",
    "bootstrap_grid",
    "decay_weight",
    "run_async_coordinator",
    "run_async_fleet",
    "run_async_party",
    "ErrorFeedback",
    "FedAvgActorBase",
    "tree_average",
    "tree_weighted_sum",
    "compress",
    "decompress",
    "PackedTree",
    "PackSpec",
    "pack_tree",
    "unpack_tree",
    "ServerOptimizer",
    "server_sgd",
    "server_adam",
    "server_yogi",
    "fedprox_loss",
    "PackedServerOpt",
    "PackedServerOptimizer",
    "PackedServerState",
    "fedac",
    "server_momentum",
    "validate_round_config",
    "mask_update",
    "unmask_sum",
    "MaskedCodeTree",
    "MaskedRoundCodec",
    "RoundMasker",
    "SecAggError",
    "privatize",
    "clip_by_global_norm",
    "run_fedavg_rounds",
    "SplitTrainer",
    "tree_median",
    "tree_trimmed_mean",
    "krum",
    "multi_krum",
]
