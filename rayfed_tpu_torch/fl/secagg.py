"""Secure aggregation: pairwise-masked integer folds, sum-only reveal.

The port of the JAX package's ``fl/secagg.py`` (Bonawitz et al.,
"Practical Secure Aggregation for Privacy-Preserving Machine Learning",
CCS 2017), a free rider on the compressed-domain integer folds of
:mod:`rayfed_tpu_torch.fl.quantize`:

1. **Key agreement rides the HELLO handshake**
   (:mod:`rayfed_tpu_torch.transport.secagg`): each party publishes an
   ephemeral per-session key in the HELLO it already performs with every
   peer, and per-(pair, session, stream, round) mask seeds derive via HKDF.
   Masks are generated, never shipped.

2. **Masking in the quantized integer domain**: after delta quantization
   onto the round's shared grid, a party's contribution becomes ``w·q +
   Σ_j ±PRG(seed_pair(j))  (mod 2³²)``: its own integer weight folded in,
   plus one pairwise keystream per active peer, added by the lower-named
   endpoint of each pair and subtracted by the higher-named
   (:func:`rayfed_tpu_torch.fl.fedavg.masked_code_kernel`, on the device of
   the codes: the party's card in the round loops).  The masked codes ship
   as i32 and fold through the unchanged integer fold at unit weight (i32
   addition wraps mod 2³²; every pair mask appears once positive and once
   negative), so the accumulator holds exactly ``Σ w_i·q_i`` and the one
   rescale emits the unmasked round's bytes.  The aggregator learns only
   the sum.

3. **Quorum-dropout mask recovery** (:mod:`rayfed_tpu_torch.fl.quorum`):
   the cutoff pins the member set; the coordinator announces it, each
   survivor replies with its pairwise seeds toward the dropped parties
   (this round's seeds only) and its self-mask seed, and the coordinator
   subtracts the orphaned masks (:func:`mask_correction`) before the
   finalize rescale.

The keystream and the net mask are numpy on the host, exactly as the JAX
package computes them (AES-256-CTR or numpy's Philox, summed in ``uint32``):
a torch or CUDA generator would be another stream, and a torch party's masks
must cancel against a JAX party's in the same round.  The i32 steps use
torch ``int32`` adds on bitcast views of the ``uint32`` words, the same ring
mod 2³² (torch has no ``uint32`` arithmetic).

This module also holds the seed-era in-process primitives
(:func:`pairwise_key`, :func:`mask_update`, :func:`unmask_sum`); the
``fl/secure.py`` module is a deprecated shim over them.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from rayfed_tpu_torch import tree_util
from rayfed_tpu_torch.fl.compression import PackedTree, PackSpec
from rayfed_tpu_torch.fl.quantize import QuantGrid, QuantizedPackedTree, RoundCodec, _device_of
from rayfed_tpu_torch.transport.secagg import (  # noqa: F401  (re-exported API)
    HAVE_AES,
    HAVE_X25519,
    SECAGG_STATS,
    SECAGG_VERSION,
    KeyAgreement,
    SecAggError,
    hkdf_sha256,
)

logger = logging.getLogger(__name__)

# Wire dtype of masked contributions: the codes widen to i32 and live in the
# mod-2³² ring the masks are drawn from (a narrower masked code would leak
# through the wrap).
MASKED_WIRE_DTYPE = "int32"


# ---------------------------------------------------------------------------
# Mask keystream (PRG)
# ---------------------------------------------------------------------------


def prg_mask(seed: bytes, n: int, scheme: Optional[str] = None) -> np.ndarray:
    """Expand a 256-bit pair seed into ``n`` uint32 mask words (host).

    ``scheme``: ``"aes"``, the AES-256-CTR keystream (the ``cryptography``
    optional dependency), or ``"philox"``, numpy's Philox counter PRG keyed
    from the seed (the stdlib fallback; statistically strong but not a
    cryptographic PRG).  Defaults to the best available.  Both endpoints of
    a pair must expand the same keystream: the scheme is advertised in the
    HELLO suite and a mismatch fails at seed derivation.
    """
    if len(seed) < 32:
        raise SecAggError(f"prg_mask needs a 32-byte seed, got {len(seed)}")
    if scheme is None:
        scheme = "aes" if HAVE_AES else "philox"
    n = int(n)
    if scheme == "aes":
        from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

        enc = Cipher(algorithms.AES(seed[:32]), modes.CTR(b"\x00" * 16)).encryptor()
        stream = enc.update(b"\x00" * (4 * n))
        return np.frombuffer(stream, dtype="<u4").copy()
    if scheme == "philox":
        key = np.frombuffer(seed[:16], np.uint64)
        gen = np.random.Generator(np.random.Philox(key=key))
        return gen.integers(0, 1 << 32, size=n, dtype=np.uint32)
    raise SecAggError(f"unknown mask PRG scheme {scheme!r}")


# ---------------------------------------------------------------------------
# Per-round masking
# ---------------------------------------------------------------------------


class RoundMasker:
    """One party's mask state for ONE round attempt.

    Binds the key-agreement plane to a ``(session, stream, round)``: derives
    (and caches) the pair seed toward every active peer, expands the
    party's **net mask** ``Σ_j ±PRG(seed_j)`` (sign by sorted-name order),
    and answers dropout recovery with the seeds toward the dropped parties.
    A coordinator failover re-attempts the round under a fresh stream, so a
    fresh masker per attempt.

    ``weight``: this party's integral fold weight; the masked wire value is
    ``weight·q + net mask``, so unit-weight integer folds reproduce the
    weighted sum (weighted pairwise masks could not cancel).

    ``self_mask`` (quorum rounds): Bonawitz double masking.  The net mask
    also holds ``PRG(b)`` for a private per-round seed ``b``, revealed only
    if this party made the round's member set, so a deadline-excluded but
    live straggler's late payload stays noise after the survivors reveal
    their pairwise seeds toward it.  The all-of-n streaming path runs
    pairwise only (``self_mask=False``).

    :meth:`prefetch` expands the net mask on a background thread, so the
    keystream overlaps local training and the wire.
    """

    def __init__(
        self,
        keys: KeyAgreement,
        party: str,
        peers: Sequence[str],
        *,
        session: str,
        stream: str,
        round_index: int,
        weight: int = 1,
        self_mask: bool = False,
    ) -> None:
        if keys is None:
            raise SecAggError(
                "secure aggregation needs the transport's key-agreement "
                "plane (TransportManager.secagg_keys) — this transport "
                "has none"
            )
        self._keys = keys
        self.party = str(party)
        self.peers = sorted(str(p) for p in peers)
        if self.party in self.peers:
            raise SecAggError("a party cannot be its own mask peer")
        self.session = str(session)
        self.stream = str(stream)
        self.round_index = int(round_index)
        self.weight = int(weight)
        if self.weight < 0:
            raise SecAggError(
                f"masked folds need a non-negative integral weight, got "
                f"{weight!r}"
            )
        # Private randomness, never derived from shared state: a failover
        # attempt builds a fresh masker and so a fresh b.
        self._self_seed: Optional[bytes] = os.urandom(32) if self_mask else None
        self._seeds: Dict[str, bytes] = {}
        self._net: Optional[np.ndarray] = None
        self._net_thread: Optional[threading.Thread] = None
        self._net_err: Optional[BaseException] = None
        self._lock = threading.Lock()

    def seed_for(self, peer: str) -> bytes:
        """The (cached) pair seed toward ``peer`` for this round."""
        with self._lock:
            s = self._seeds.get(peer)
        if s is None:
            s = self._keys.pair_seed(
                peer, session=self.session, stream=self.stream,
                round_index=self.round_index,
            )
            with self._lock:
                self._seeds[peer] = s
        return s

    def _compute_net(self, n: int) -> np.ndarray:
        net = np.zeros(n, np.uint32)
        if self._self_seed is not None:
            net += prg_mask(self._self_seed, n, self._keys.prg_scheme)
        for peer in self.peers:
            ks = prg_mask(self.seed_for(peer), n, self._keys.prg_scheme)
            if self.party < peer:
                net += ks  # uint32 wraps mod 2**32, the ring we want
            else:
                net -= ks
        return net

    def self_seed_hex(self) -> str:
        """The self-mask seed, hex: revealed only by a party that made the
        member set (its contribution is in the sum)."""
        if self._self_seed is None:
            raise SecAggError(
                "this masker carries no self-mask (self_mask=False — "
                "the all-of-n streaming path)"
            )
        return self._self_seed.hex()

    def prefetch(self, n: int) -> None:
        """Start expanding the net mask on a background thread (no-op if
        already running or done).  :meth:`net_mask` joins it."""
        with self._lock:
            if self._net is not None or self._net_thread is not None:
                return

            def _run():
                try:
                    net = self._compute_net(int(n))
                    with self._lock:
                        self._net = net
                # fedlint: disable=FED004 — transferred, not swallowed: the error re-raises from net_mask() on the round's thread
                except BaseException as e:
                    self._net_err = e

            self._net_thread = threading.Thread(target=_run, name="rayfed-secagg-prg", daemon=True)
            self._net_thread.start()

    def net_mask(self, n: int) -> np.ndarray:
        """This party's net mask for an ``n``-element code buffer (uint32,
        host; added to ``weight·q`` mod 2³²)."""
        n = int(n)
        with self._lock:
            th = self._net_thread
        if th is not None:
            th.join()
            if self._net_err is not None:
                raise self._net_err
        with self._lock:
            if self._net is not None:
                if self._net.size != n:
                    raise SecAggError(
                        f"prefetched mask covers {self._net.size} "
                        f"elements, round needs {n}"
                    )
                return self._net
        net = self._compute_net(n)
        with self._lock:
            self._net = net
        return net

    def recovery_seeds(self, dropped: Sequence[str]) -> Dict[str, str]:
        """This survivor's pairwise seeds toward the dropped parties, hex:
        the recovery reply body (this round's seeds only)."""
        out: Dict[str, str] = {}
        for j in dropped:
            j = str(j)
            if j == self.party:
                continue
            if j not in self.peers:
                raise SecAggError(
                    f"recovery asked for seeds toward {j!r}, which was "
                    f"not a mask peer this round ({self.peers})"
                )
            out[j] = self.seed_for(j).hex()
        return out


def _seed_from_hex(hexseed: str, who: str, what: str) -> bytes:
    try:
        return bytes.fromhex(hexseed)
    except (ValueError, TypeError) as e:
        raise SecAggError(f"malformed {what} from {who!r}: not a hex seed ({e})") from None


def mask_correction(
    survivor_seeds: Dict[str, Dict[str, str]],
    dropped: Sequence[str],
    n: int,
    prg_scheme: Optional[str] = None,
    members: Optional[Sequence[str]] = None,
    self_seeds: Optional[Dict[str, str]] = None,
) -> np.ndarray:
    """The mask correction of a quorum round's cutoff (coordinator, host).

    ``survivor_seeds``: ``{survivor: {dropped party: seed hex}}``, one entry
    per member of the pinned set.  The folded accumulator holds, beyond
    ``Σ_{i∈M} w_i·q_i``, the residual ``Σ_{i∈M} Σ_{j∈D} ±PRG(seed_ij)``;
    this expands exactly that residual (uint32, mod 2³²) for the aggregator
    to subtract before the rescale.  ``self_seeds``: ``{member: self-mask
    seed hex}``, each member's ``PRG(b_i)`` added here.

    Raises when a (survivor, dropped) seed or a member self-seed is missing
    and, with ``members``, when the survivor set is not exactly the pinned
    member set: an incomplete correction would silently corrupt the round.
    """
    if members is not None:
        want = {str(p) for p in members}
        have = {str(p) for p in survivor_seeds}
        if have != want:
            raise SecAggError(
                f"mask recovery incomplete: seeds collected from "
                f"{sorted(have)} but the pinned member set is "
                f"{sorted(want)} — cannot finalize the round"
            )
    dropped = sorted(str(j) for j in dropped)
    corr = np.zeros(int(n), np.uint32)
    recovered = 0
    for i in sorted(survivor_seeds):
        seeds = survivor_seeds[i]
        for j in dropped:
            if j == i:
                continue
            hexseed = seeds.get(j)
            if not hexseed:
                raise SecAggError(
                    f"mask recovery incomplete: survivor {i!r} supplied "
                    f"no seed toward dropped party {j!r} — cannot "
                    f"finalize the round"
                )
            ks = prg_mask(_seed_from_hex(hexseed, i, f"recovery seed toward {j!r}"), int(n), prg_scheme)
            if i < j:
                corr += ks
            else:
                corr -= ks
            recovered += 1
    if self_seeds is not None:
        for i in sorted({str(p) for p in (members or self_seeds)}):
            b = self_seeds.get(i)
            if not b:
                raise SecAggError(
                    f"mask recovery incomplete: member {i!r} supplied "
                    f"no self-mask seed — cannot finalize the round"
                )
            corr += prg_mask(_seed_from_hex(b, i, "self-mask seed"), int(n), prg_scheme)
    SECAGG_STATS["recovered_seeds"] += recovered
    return corr


# ---------------------------------------------------------------------------
# Recovery control messages (a cross-party contract, fingerprinted by
# tool/check_wire_format.py: payload schemas, no frame-layout change)
# ---------------------------------------------------------------------------


def make_recovery_request(members: Sequence[str], dropped: Sequence[str]) -> Dict[str, Any]:
    """The coordinator's post-cutoff announcement to every active party:
    the pinned member set and the dropped parties whose masks need recovery
    (empty ``dr``: nothing to recover)."""
    return {
        "v": SECAGG_VERSION,
        "m": sorted(str(p) for p in members),
        "dr": sorted(str(p) for p in dropped),
    }


def make_recovery_reply(party: str, seeds: Dict[str, str], self_seed: str) -> Dict[str, Any]:
    """One member's cutoff reply: its pairwise seeds toward the dropped
    parties (hex) and its own self-mask seed ``b``."""
    return {
        "v": SECAGG_VERSION,
        "p": str(party),
        "sd": dict(seeds),
        "b": str(self_seed),
    }


def check_recovery_message(msg: Any, kind: str) -> Dict[str, Any]:
    """Validate a received recovery request/reply (version and shape);
    raises naming the problem."""
    if not isinstance(msg, dict):
        raise SecAggError(f"malformed secagg {kind}: {type(msg).__name__}")
    try:
        ver = int(msg.get("v", 0))
    except (TypeError, ValueError):
        raise SecAggError(f"malformed secagg {kind}: non-integer version {msg.get('v')!r}") from None
    if ver > SECAGG_VERSION:
        raise SecAggError(
            f"secagg {kind} uses schema v{msg.get('v')}; this party "
            f"speaks up to v{SECAGG_VERSION}"
        )
    want = ("m", "dr") if kind == "request" else ("p", "sd", "b")
    for k in want:
        if k not in msg:
            raise SecAggError(f"secagg {kind} is missing field {k!r}")
    return msg


# ---------------------------------------------------------------------------
# Masked wire form + codec
# ---------------------------------------------------------------------------


class MaskedCodeTree(QuantizedPackedTree):
    """Wire form of a masked contribution: ``weight·q + net mask`` as an i32
    buffer, with the round grid's descriptor riding along.  It travels under
    the JAX package's class name (``serialization.SECAGG_WIRE_MODULE``).

    Not decodable: a masked buffer is uniform ring noise without the peers'
    contributions, so :meth:`dequantize` and :meth:`unpack` raise.  Fold it
    with a masked :class:`~rayfed_tpu_torch.fl.streaming.StreamingAggregator`.
    """

    __slots__ = ()

    def dequantize(self, out_dtype: Any = np.float32, ref: Optional[Any] = None):
        raise SecAggError(
            "a MaskedCodeTree is uniform ring noise on its own — only "
            "the masked FOLD (StreamingAggregator(masked=True)) can "
            "cancel the pairwise masks; there is nothing to dequantize"
        )

    def unpack(self, dtype: Any = None):
        raise SecAggError("a MaskedCodeTree cannot be unpacked — see dequantize")

    def __reduce__(self):
        return (
            MaskedCodeTree,
            (self.buf, self.scales, self.zps, self.passthrough, self.spec, self.gmeta),
        )

    def __repr__(self) -> str:  # pragma: no cover
        return f"MaskedCodeTree({self.gmeta.total_elems} masked i32 codes on grid fp={self.gmeta.fp:#010x})"


tree_util.register_pytree_node(
    MaskedCodeTree,
    lambda mt: ((mt.buf, mt.scales, mt.zps, *mt.passthrough), (mt.spec, mt.gmeta)),
    lambda aux, ch: MaskedCodeTree(ch[0], ch[1], ch[2], tuple(ch[3:]), aux[0], aux[1]),
)


class MaskedRoundCodec(RoundCodec):
    """The masked sender-side codec: grid quantization (the inherited
    fingerprint check and error-feedback commit) followed by the
    weight-and-mask step, on the device of the contribution (the party's
    card in the round loops); the masked codes come back to the host, as
    the quantized codes do.  Drop-in where a
    :class:`~rayfed_tpu_torch.fl.quantize.RoundCodec` goes."""

    __slots__ = ("masker",)

    def __init__(self, grid: Optional[QuantGrid], ref: Optional[Any],
                 scope: Optional[str], masker: RoundMasker) -> None:
        if grid is None:
            raise SecAggError(
                "secure aggregation requires the shared quantization "
                "grid (wire_quant) — masks live in the integer domain"
            )
        super().__init__(grid, ref, scope)
        self.masker = masker

    def to_wire(self, value: Any) -> MaskedCodeTree:
        if isinstance(value, MaskedCodeTree):
            raise SecAggError("contribution is already masked")
        # The keystream expands beside the quantize step.
        self.masker.prefetch(self.grid.total_elems)
        qt = super().to_wire(value)
        if qt.passthrough:
            # Non-float leaves do not live on the packed buffer, so the masks
            # cannot cover them: shipping them in the clear would break the
            # "uniform ring noise" guarantee.
            raise SecAggError(
                f"secure aggregation covers the packed float buffer "
                f"only, but this update carries "
                f"{len(qt.passthrough)} non-float (passthrough) "
                f"leaf(s) that would ship UNMASKED — drop them from "
                f"the update tree (or encode them as floats) before "
                f"masking"
            )
        from rayfed_tpu_torch.fl.fedavg import as_tensor, masked_code_kernel

        device = _device_of(value.buf if isinstance(value, PackedTree) else None, self.ref)
        mask = self.masker.net_mask(self.grid.total_elems)
        buf = masked_code_kernel(as_tensor(qt.buf, device), self.masker.weight, mask)
        SECAGG_STATS["masked_rounds"] += 1
        spec = PackSpec(qt.spec.entries, qt.spec.treedef, MASKED_WIRE_DTYPE)
        # Host codes, as the quantized tree's: the payload is the JAX
        # package's, byte for byte.
        return MaskedCodeTree(buf.cpu().numpy(), qt.scales, qt.zps, qt.passthrough, spec, qt.gmeta)


# ---------------------------------------------------------------------------
# Seed-era in-process primitives (fl/secure.py is a deprecated shim over
# these)
# ---------------------------------------------------------------------------


def pairwise_key(group_key: bytes, a: str, b: str, round_num: int) -> bytes:
    """256-bit seed for the (a, b) pair at one round, order-independent:
    the seed-era group-key derivation behind :func:`mask_update` and
    :func:`unmask_sum` (the transport rounds derive their seeds from the
    HELLO key agreement instead).  Length-prefixed components, so names
    containing ``|`` cannot collide across pairs."""
    lo, hi = sorted((a, b))
    lo_b, hi_b = lo.encode(), hi.encode()
    return hashlib.sha256(
        b"rayfed-secagg|%d:%s|%d:%s|%d|" % (len(lo_b), lo_b, len(hi_b), hi_b, round_num)
        + group_key
    ).digest()


def _encode(tree: Any, clip: float, frac_bits: int) -> Any:
    """Float tree → int32 fixed point, the two's-complement words of the
    uint32 ring.  Values are clipped to ±``clip`` first (fixed point needs a
    known range); ``clip·2^frac_bits < 2³¹`` keeps the int32 exact."""
    scale = float(2**frac_bits)

    def enc(x):
        x = torch.clamp(torch.as_tensor(x).to(torch.float32), -clip, clip)
        return torch.round(x * scale).to(torch.int32)

    return tree_util.tree_map(enc, tree)


def _decode(tree: Any, frac_bits: int) -> Any:
    """int32 ring words of a sum → float tree: the two's-complement read,
    exact while |true sum| < 2³¹ (which :func:`unmask_sum` guards)."""
    scale = float(2**frac_bits)
    return tree_util.tree_map(lambda x: _as_ring(x).to(torch.float32) / scale, tree)


def _as_ring(x: Any) -> torch.Tensor:
    """A uint32 or int32 tensor (or array) as its int32 words."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x).view(np.int32))
    return x.view(torch.int32) if x.dtype == torch.uint32 else x


def _mask_for(seed: bytes, tree: Any) -> Any:
    """One uint32 mask word per element (as int32), expanded from the
    256-bit pair seed by SHAKE-256, domain-separated per leaf index."""
    leaves, treedef = tree_util.tree_flatten(tree)
    masks = []
    for i, leaf in enumerate(leaves):
        stream = hashlib.shake_256(seed + b"|leaf|%d" % i).digest(4 * leaf.numel())
        words = np.frombuffer(stream, dtype=np.uint32).view(np.int32).reshape(tuple(leaf.shape))
        masks.append(torch.from_numpy(words.copy()))
    return tree_util.tree_unflatten(masks, treedef)


def mask_update(
    tree: Any,
    *,
    party: str,
    parties: Sequence[str],
    round_num: int,
    group_key: bytes,
    clip: float = 8.0,
    frac_bits: int = 16,
) -> Any:
    """Fixed-point-encode ``tree`` and add this party's pairwise masks.

    The in-process (whole-tree, group-key) primitive; use
    ``run_fedavg_rounds(secure_agg=True)`` for transport rounds.  Returns a
    tree of ``torch.uint32`` CPU tensors, the JAX package's words: without
    the peers' masked updates it is uniformly random in the ring.
    ``clip``/``frac_bits`` must match across parties and in
    :func:`unmask_sum`.
    """
    if party not in parties:
        raise ValueError(f"party {party!r} not in {list(parties)!r}")
    out = _encode(tree, clip, frac_bits)
    for peer in parties:
        if peer == party:
            continue
        mask = _mask_for(pairwise_key(group_key, party, peer, round_num), out)
        sign = 1 if party < peer else -1
        # int32 adds wrap mod 2^32: the ring of the uint32 words.
        out = tree_util.tree_map(
            (lambda o, m: o + m) if sign > 0 else (lambda o, m: o - m), out, mask,
        )
    return tree_util.tree_map(lambda o: o.view(torch.uint32), out)


def unmask_sum(masked_trees: Sequence[Any], *, frac_bits: int = 16, clip: float = 8.0) -> Any:
    """Sum all parties' masked updates; the masks cancel bit-exactly.

    Returns the float **sum** of the clipped updates (divide by the party
    count for the average).  ``n·clip`` must stay below
    ``2^(31−frac_bits)`` or the ring wraps.
    """
    n = len(masked_trees)
    if n == 0:
        raise ValueError("unmask_sum needs at least one masked update")
    if n * clip >= float(2 ** (31 - frac_bits)):
        raise ValueError(
            f"{n} parties at clip={clip} overflow the ring at "
            f"frac_bits={frac_bits}; lower frac_bits or clip"
        )
    total = tree_util.tree_map(_as_ring, masked_trees[0])
    for t in masked_trees[1:]:
        total = tree_util.tree_map(lambda a, b: a + _as_ring(b), total, t)
    return _decode(total, frac_bits)


__all__ = [
    "HAVE_AES",
    "HAVE_X25519",
    "MASKED_WIRE_DTYPE",
    "SECAGG_STATS",
    "SECAGG_VERSION",
    "KeyAgreement",
    "MaskedCodeTree",
    "MaskedRoundCodec",
    "RoundMasker",
    "SecAggError",
    "check_recovery_message",
    "hkdf_sha256",
    "make_recovery_reply",
    "make_recovery_request",
    "mask_correction",
    "mask_update",
    "pairwise_key",
    "prg_mask",
    "unmask_sum",
]
