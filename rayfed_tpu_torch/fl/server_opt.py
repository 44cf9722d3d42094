"""Packed-domain server optimization: FedAC and server momentum as one step
beside the round's single finalize, cutting the number of rounds.

The port of the JAX package's ``fl/server_opt.py``, with the same names and
structure:

- :class:`PackedServerOpt` — the optimizer *spec* (kind and
  hyperparameters; pure data, hashable, equal on every controller).
  :func:`server_momentum` builds FedAvgM, :func:`fedac` FedAC's
  linear-coupling acceleration ``(λ, γ, β)`` (Yuan & Ma 2020):
  conservative step ``y' = x − λ·Δ``, aggressive step ``z' = z − γ·Δ``,
  broadcast point ``x' = (1−β)·y' + β·z'``, with ``Δ = x − avg`` the
  round's pseudo-gradient.  ``λ=1, β=0`` (or ``momentum=0, lr=1``) is plain
  FedAvg bit for bit.
- :class:`PackedServerState` — the auxiliary sequence as packed f32
  buffers (one flat buffer per sequence).  It is a pytree node and travels
  under the JAX package's module path, so a welcome's state blob decodes in
  either package.
- :class:`PackedServerOptimizer` — one controller's replica of the state
  and the step/resync discipline every topology shares.  The step
  (:func:`rayfed_tpu_torch.fl.fedavg.server_step_kernel`) runs where the
  aggregate finalizes (the streaming or quorum coordinator, the hierarchy's
  root; every controller on the ring), on the aggregate's device, and its
  output is what the downlink ships.

**State without a state broadcast.**  After each round every controller
advances its replica with :func:`~rayfed_tpu_torch.fl.fedavg.
server_resync_kernel` from the broadcast pair ``(x, x')``, buffers the whole
cluster already agrees on byte for byte.  The coordinator resyncs from the
decoded broadcast too, so a downlink's quantization error enters every
replica alike and any controller can take over as the quorum coordinator.
The step and the resync give the JAX package's bytes on the CPU and the
same bytes on the card, so torch and JAX controllers share one trajectory.

``secure_agg`` is refused (``fl.trainer.validate_round_config``), as in the
JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rayfed_tpu_torch import tree_util

# How many auxiliary packed buffers each optimizer kind carries.
_STATE_WIDTH = {"momentum": 1, "fedac": 1}


def _flat_f32(buf: Any, device: Optional[torch.device] = None) -> torch.Tensor:
    """A packed buffer (tensor or array) as a flat f32 tensor, on its own
    device unless ``device`` is given."""
    from rayfed_tpu_torch.fl.fedavg import as_tensor

    return as_tensor(buf, device).reshape(-1).to(torch.float32)


def _numel(buf: Any) -> int:
    return int(buf.numel() if isinstance(buf, torch.Tensor) else np.size(buf))


class PackedServerOpt:
    """A server-optimizer *spec*: kind and static hyperparameters.

    Pure data: every controller builds an equal spec from the same
    arguments, the kernels are cached per spec, and the spec stamps the
    state so that a foreign state is refused.
    """

    __slots__ = ("kind", "hyper")

    def __init__(self, kind: str, hyper: Sequence[float]) -> None:
        if kind not in _STATE_WIDTH:
            raise ValueError(
                f"unknown server-opt kind {kind!r} — one of "
                f"{sorted(_STATE_WIDTH)}"
            )
        self.kind = str(kind)
        self.hyper = tuple(float(h) for h in hyper)
        if kind == "momentum":
            lr, momentum = self.hyper
            if not lr > 0:
                raise ValueError(f"momentum lr must be > 0, got {lr}")
            if not 0.0 <= momentum < 1.0:
                raise ValueError(
                    f"momentum coefficient must be in [0, 1), got "
                    f"{momentum}"
                )
        else:  # fedac
            lam, gamma, beta = self.hyper
            if not lam > 0:
                raise ValueError(f"fedac lam must be > 0, got {lam}")
            if not gamma >= lam:
                raise ValueError(
                    f"fedac gamma must be >= lam (the aggressive step "
                    f"dominates the conservative one), got gamma="
                    f"{gamma} < lam={lam}"
                )
            if not 0.0 <= beta < 1.0:
                raise ValueError(
                    f"fedac beta must be in [0, 1), got {beta}"
                )

    @property
    def n_state(self) -> int:
        return _STATE_WIDTH[self.kind]

    def init(self, x_buf: Any, device: Optional[Any] = None) -> "PackedServerState":
        """Fresh state for a run starting at packed buffer ``x_buf``, on
        ``device`` (default ``x_buf``'s): momentum starts at zero, FedAC's
        aggressive sequence at the initial point (``z₀ = x₀``)."""
        x = _flat_f32(x_buf, device)
        if self.kind == "momentum":
            bufs: Tuple[Any, ...] = (torch.zeros_like(x),)
        else:  # fedac
            bufs = (x,)
        return PackedServerState(self.kind, self.hyper, bufs)

    def describe(self) -> Dict[str, Any]:
        """The JSON-safe spec stamp."""
        return {"kind": self.kind, "hyper": [float(h) for h in self.hyper]}

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, PackedServerOpt)
            and self.kind == other.kind
            and self.hyper == other.hyper
        )

    def __hash__(self) -> int:
        return hash((self.kind, self.hyper))

    def __repr__(self) -> str:  # pragma: no cover
        return f"PackedServerOpt({self.kind!r}, {self.hyper})"


def server_momentum(lr: float = 1.0, momentum: float = 0.9) -> PackedServerOpt:
    """FedAvgM over packed buffers: ``x' = x − lr·(momentum·m + Δ)``.
    ``lr=1, momentum=0`` is plain FedAvg bit for bit."""
    return PackedServerOpt("momentum", (lr, momentum))


def fedac(lam: float = 1.0, gamma: float = 3.0, beta: float = 0.5) -> PackedServerOpt:
    """FedAC (Yuan & Ma 2020) as a server recurrence over packed buffers:
    ``lam`` the conservative step, ``gamma >= lam`` the aggressive step over
    the auxiliary sequence, ``beta`` the aggressive sequence's weight in
    the next broadcast point.  ``lam=1, beta=0`` is plain FedAvg bit for
    bit."""
    return PackedServerOpt("fedac", (lam, gamma, beta))


class PackedServerState:
    """Server-optimizer auxiliary sequences as packed f32 buffers (tensors
    on the device of the broadcast they were resynced from, or numpy arrays
    from a JAX party).  A pytree node (children the buffers, aux the spec);
    it pickles under the JAX package's module path
    (``serialization.SERVER_OPT_WIRE_MODULE``) with the same slots."""

    __slots__ = ("kind", "hyper", "bufs")

    def __init__(self, kind: str, hyper: Tuple[float, ...], bufs: Tuple[Any, ...]) -> None:
        self.kind = str(kind)
        self.hyper = tuple(float(h) for h in hyper)
        self.bufs = tuple(bufs)
        width = _STATE_WIDTH.get(self.kind)
        if width is not None and len(self.bufs) != width:
            raise ValueError(
                f"{self.kind} server-opt state carries {width} "
                f"buffer(s), got {len(self.bufs)}"
            )

    def __repr__(self) -> str:  # pragma: no cover
        sizes = [_numel(b) for b in self.bufs]
        return f"PackedServerState({self.kind!r}, {self.hyper}, bufs={sizes})"


tree_util.register_pytree_node(
    PackedServerState,
    lambda s: (tuple(s.bufs), (s.kind, s.hyper)),
    lambda aux, ch: PackedServerState(aux[0], aux[1], tuple(ch)),
)


def describe_server_opt(server_opt: Optional[Any]) -> Dict[str, Any]:
    """The stamp for any ``server_opt`` argument: ``{"kind": "none"}`` for
    plain FedAvg, ``{"kind": "fedopt"}`` for a legacy
    :class:`~rayfed_tpu_torch.fl.fedopt.ServerOptimizer`, and the kind and
    hyperparameters of a :class:`PackedServerOpt`."""
    if server_opt is None:
        return {"kind": "none"}
    if isinstance(server_opt, PackedServerOpt):
        return server_opt.describe()
    return {"kind": "fedopt"}


def check_snapshot_server_opt(stored: Optional[Dict[str, Any]], expected: Dict[str, Any]) -> None:
    """Refuse, naming both sides, to resume a run whose ``server_opt``
    differs from the snapshot's stamp.  ``stored=None`` (a snapshot from
    before the stamp) passes only for the stateless configs (``none``,
    ``fedopt``)."""
    if stored is None:
        if expected["kind"] in ("none", "fedopt"):
            return
        raise ValueError(
            f"checkpoint carries no server_opt stamp (written before "
            f"packed server optimization existed?) but this run uses "
            f"server_opt={expected} — its state buffers cannot be in "
            f"the snapshot; restart from scratch or drop server_opt"
        )
    stored_n = {
        "kind": str(stored.get("kind")),
        **({"hyper": [float(h) for h in stored["hyper"]]} if "hyper" in stored else {}),
    }
    if stored_n != expected:
        raise ValueError(
            f"server_opt mismatch between the run and its checkpoint: "
            f"this run is configured with {expected}, the snapshot was "
            f"written by {stored_n} — restoring would silently "
            f"{'reset' if expected['kind'] != 'none' else 'discard'} "
            f"the optimizer trajectory; resume with the matching "
            f"server_opt or point the checkpointer elsewhere"
        )


class PackedServerOptimizer:
    """One controller's server-opt runtime: the replicated state plus the
    step/resync discipline.  ``device``: where the state lives and the step
    and resync run (the round drivers pass the party's card); None runs
    each on the device of the buffer it is given.  Per round, on every
    controller with the same arguments:

    1. ``ensure(x_buf)`` — the state at the round's shared starting buffer
       (first round only);
    2. ``step_fn(x_buf)`` — the finalize-side hook for the aggregators
       (``server_step=``; the ring and the one-shot path call it on the
       aggregate themselves): the exact f32 aggregate in, the post-step
       model out, on the aggregate's device;
    3. ``resync(x_buf, new_buf)`` — once the broadcast landed, the state
       advances from the byte-agreed pair ``(x, x')``.  An aborted round
       never resyncs, so a retry re-runs the same step from the same state.
    """

    __slots__ = ("opt", "_state", "_device")

    def __init__(self, opt: PackedServerOpt, state: Optional[PackedServerState] = None,
                 device: Optional[Any] = None) -> None:
        if not isinstance(opt, PackedServerOpt):
            raise TypeError(
                f"PackedServerOptimizer wraps a PackedServerOpt spec, "
                f"got {type(opt).__name__} (legacy fedopt.ServerOptimizer "
                f"optimizers keep the unpacked tree path)"
            )
        self.opt = opt
        self._device = None if device is None else torch.device(device)
        self._state: Optional[PackedServerState] = None
        if state is not None:
            self.load_state(state)

    @property
    def state(self) -> Optional[PackedServerState]:
        return self._state

    def load_state(self, state: PackedServerState) -> None:
        """Adopt a restored or welcomed state (onto the optimizer's device);
        its spec must be this run's (a foreign state silently adopted would
        reset the trajectory)."""
        if not isinstance(state, PackedServerState):
            raise TypeError(f"expected a PackedServerState, got {type(state).__name__}")
        if (state.kind, state.hyper) != (self.opt.kind, self.opt.hyper):
            raise ValueError(
                f"restored server-opt state was written by "
                f"({state.kind}, {state.hyper}), this run is "
                f"({self.opt.kind}, {self.opt.hyper})"
            )
        if self._device is not None:
            state = PackedServerState(state.kind, state.hyper,
                                      tuple(_flat_f32(b, self._device) for b in state.bufs))
        self._state = state

    def ensure(self, x_buf: Any) -> None:
        if self._state is None:
            self._state = self.opt.init(x_buf, self._device)

    def step_fn(self, x_buf: Any):
        """The round's finalize-side hook: ``fn(aggregate PackedTree) ->
        post-step PackedTree`` (an f32 buffer on the aggregate's device;
        passthrough leaves keep the aggregate's per-leaf reduce)."""
        from rayfed_tpu_torch.fl.fedavg import server_step_kernel

        if self._state is None:
            raise RuntimeError("call ensure(x_buf) before step_fn")
        state = self._state
        kernel = server_step_kernel(self.opt.kind, self.opt.hyper)
        n_state = _numel(state.bufs[0])

        def _step(result: Any) -> Any:
            from rayfed_tpu_torch.fl.compression import PackedTree, PackSpec
            from rayfed_tpu_torch.fl.quantize import QuantizedPackedTree

            if isinstance(result, QuantizedPackedTree):
                raise TypeError(
                    "the server step consumes the FINALIZED float "
                    "aggregate — got integer codes; apply it between "
                    "finalize and the downlink recode"
                )
            if not isinstance(result, PackedTree):
                raise TypeError(
                    f"the server step consumes a PackedTree aggregate, "
                    f"got {type(result).__name__}"
                )
            n = _numel(result.buf)
            if n != n_state:
                raise ValueError(
                    f"aggregate has {n} elements, server-opt state "
                    f"covers {n_state} — the round's packed layout "
                    f"changed mid-run"
                )
            avg = result.buf if self._device is None else _flat_f32(result.buf, self._device)
            buf = kernel(x_buf, avg, *state.bufs)
            spec = result.spec
            if spec.wire_dtype != "float32":
                spec = PackSpec(spec.entries, spec.treedef, "float32")
            return PackedTree(buf, result.passthrough, spec)

        return _step

    def resync(self, x_buf: Any, new_buf: Any) -> None:
        """Advance the state replica from the round's byte-agreed broadcast
        pair (on the broadcast's device unless the optimizer has one)."""
        from rayfed_tpu_torch.fl.fedavg import server_resync_kernel

        if self._state is None:
            raise RuntimeError("resync before any round was stepped")
        new = _flat_f32(new_buf, self._device)
        x = _flat_f32(x_buf, new.device)
        if new.numel() != x.numel():
            raise ValueError(
                f"broadcast has {new.numel()} elements, server-opt "
                f"state covers {x.numel()}"
            )
        bufs = server_resync_kernel(self.opt.kind, self.opt.hyper)(x, new, *self._state.bufs)
        self._state = PackedServerState(self.opt.kind, self.opt.hyper, tuple(bufs))

    def describe(self) -> Dict[str, Any]:
        return self.opt.describe()


def reference_step(opt: PackedServerOpt, x: np.ndarray, avg: np.ndarray,
                   state: List[np.ndarray]) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Plain numpy of one (step, true state update) round, what the step is
    held against in tests and on the card (the running state advances
    through the resync instead)."""
    x = np.asarray(x, np.float32)
    avg = np.asarray(avg, np.float32)
    if opt.kind == "momentum":
        lr, momentum = opt.hyper
        m = momentum * state[0] + (x - avg)
        return (x - lr * m).astype(np.float32), [m.astype(np.float32)]
    lam, gamma, beta = opt.hyper
    delta = x - avg
    y_new = x - lam * delta
    z_new = state[0] - gamma * delta
    x_new = (1.0 - beta) * y_new + beta * z_new
    return x_new.astype(np.float32), [z_new.astype(np.float32)]
