"""Secure-aggregation key agreement riding the connection HELLO.

The seed-era :mod:`rayfed_tpu_torch.fl.secure` demo left pairwise key material
to the operator ("provision a group key somehow").  Here key agreement is
a **transport plane**: every party generates an ephemeral keypair per
process (per *session* — a ``fed.init`` lifetime), publishes the public
half in the connection HELLO handshake it already performs with every
peer (``wire.SECAGG_PUB_KEY``, a header key beside ``ver``/``src`` — no
frame-layout change), and records each peer's published half from the
HELLOs it receives (server side: the client's HELLO header; client side:
the server's HELLO reply).  One ping per pair is therefore enough to
establish both directions — :meth:`TransportManager.
ensure_secagg_peer_keys` does exactly that before the first masked
round.

From the pair state, per-(pair, session, stream, round) **mask seeds**
derive via HKDF-SHA256 (stdlib hmac) — masks are *generated, never
shipped*, and revealing one round's seed (dropout recovery,
:mod:`rayfed_tpu_torch.fl.secagg`) reveals nothing about any other round's:
the HKDF is one-way in the pair secret.

Two key-exchange schemes, negotiated by what both builds can do:

- ``x25519`` (preferred): an ephemeral X25519 keypair via the optional
  ``cryptography`` dependency (same optional-dep posture as
  ``transport/tls.py``); the pair secret is the Diffie-Hellman exchange,
  so **no party — the aggregator included — can derive another pair's
  masks**.
- ``nonce`` (stdlib fallback, used when ``cryptography`` is absent): the
  published value is a random per-session nonce and the pair secret is
  HKDF(group key, both nonces).  The group key is operator-provisioned
  (``RAYFED_SECAGG_GROUP_KEY`` env var or :meth:`KeyAgreement.
  set_group_key`) — anyone holding it can derive every mask, so this
  mode only protects against an aggregator that does NOT hold the group
  key.  The per-session nonces still give mask freshness across runs.

The mask keystream (PRG) scheme rides the same advertisement:

- ``aes`` (preferred, ``cryptography``): AES-256-CTR keystream — fast
  and cryptographic.
- ``philox`` (stdlib+numpy fallback): the numpy Philox counter PRG
  keyed from the seed.  Deterministic and statistically strong but NOT
  a cryptographic PRG — a dev/test fallback, loudly documented in
  ``docs/source/secure_aggregation.rst``.

Masks only cancel when both endpoints expand the identical keystream,
so a pair whose advertised suites disagree fails **loudly** at seed
derivation instead of silently folding garbage (``RAYFED_SECAGG_PRG``
pins the scheme when a mixed cluster must align downward).
"""

from __future__ import annotations

import hashlib
import hmac
import logging
import os
import threading
import time
from typing import Dict, Optional, Tuple

logger = logging.getLogger(__name__)

try:  # optional dependency, like transport/tls.py
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey,
        X25519PublicKey,
    )
    from cryptography.hazmat.primitives.serialization import (
        Encoding,
        PublicFormat,
    )

    HAVE_X25519 = True
except ImportError:  # pragma: no cover - exercised on stdlib-only builds
    HAVE_X25519 = False

try:
    from cryptography.hazmat.primitives.ciphers import (  # noqa: F401
        Cipher,
        algorithms,
        modes,
    )

    HAVE_AES = True
except ImportError:  # pragma: no cover - exercised on stdlib-only builds
    HAVE_AES = False

# Version of the secagg HELLO-value format AND of the seed-derivation
# semantics (the HKDF labels below).  Bump on any change —
# ``tool/check_wire_format.py`` fingerprints it, so drift without a bump
# fails the build like any wire drift.
SECAGG_VERSION = 1

# Cumulative per-process secure-aggregation counters, surfaced beside
# ``fl.quorum.QUORUM_STATS``.  Defined HERE (the dependency-free end of
# the transport/fl split) and re-exported by ``rayfed_tpu_torch.fl.secagg``;
# the transport side accounts ``keygen_ms``, the fl side the rest.
SECAGG_STATS: Dict[str, float] = {
    "masked_rounds": 0,
    "mask_recoveries": 0,
    "recovered_seeds": 0,
    "keygen_ms": 0.0,
}


class SecAggError(RuntimeError):
    """Secure-aggregation key agreement / masking failure."""


def _lp(*parts: bytes) -> bytes:
    """Length-prefixed concatenation: every component is framed by its
    own 4-byte big-endian length, so no two distinct component tuples
    share a preimage (a '|'-delimited scheme would let names containing
    the delimiter collide across pairs, handing one pair another pair's
    mask seed)."""
    out = []
    for p in parts:
        out.append(len(p).to_bytes(4, "big"))
        out.append(p)
    return b"".join(out)


def hkdf_sha256(ikm: bytes, info: bytes,
                salt: bytes = b"rayfed-secagg-v1", length: int = 32) -> bytes:
    """RFC 5869 HKDF-SHA256 (extract + one expand block), pure stdlib."""
    if not 1 <= length <= 32:
        raise ValueError("hkdf_sha256 emits at most one SHA-256 block")
    prk = hmac.new(salt, ikm, hashlib.sha256).digest()
    return hmac.new(prk, info + b"\x01", hashlib.sha256).digest()[:length]


def _default_prg_scheme() -> str:
    forced = os.environ.get("RAYFED_SECAGG_PRG")
    if forced:
        if forced not in ("aes", "philox"):
            raise SecAggError(
                f"RAYFED_SECAGG_PRG={forced!r} — expected 'aes' or 'philox'"
            )
        if forced == "aes" and not HAVE_AES:
            raise SecAggError(
                "RAYFED_SECAGG_PRG=aes but the 'cryptography' package is "
                "not installed (pip install 'rayfed-tpu[secagg]')"
            )
        return forced
    return "aes" if HAVE_AES else "philox"


class KeyAgreement:
    """Per-process (per-session) secure-aggregation key state.

    One instance per :class:`~rayfed_tpu_torch.transport.manager.
    TransportManager` — NOT module-global, so several in-process parties
    (tests, benches) each hold their own keypair.  Thread-safe: peers
    are recorded from transport-loop threads (HELLO dispatch) and read
    from driver/aggregator threads.
    """

    def __init__(self, party: str, group_key: Optional[bytes] = None) -> None:
        self.party = str(party)
        t0 = time.perf_counter()
        if HAVE_X25519:
            self.kex_scheme = "x25519"
            self._priv = X25519PrivateKey.generate()
            self._pub = self._priv.public_key().public_bytes(
                Encoding.Raw, PublicFormat.Raw
            )
        else:
            # Stdlib fallback: a fresh per-session nonce.  The pair
            # secret then needs the operator-provisioned group key —
            # see the module docstring for what this mode protects.
            self.kex_scheme = "nonce"
            self._priv = None
            self._pub = os.urandom(32)
        SECAGG_STATS["keygen_ms"] += (time.perf_counter() - t0) * 1e3
        self.prg_scheme = _default_prg_scheme()
        if group_key is None:
            env = os.environ.get("RAYFED_SECAGG_GROUP_KEY")
            group_key = env.encode() if env else None
        self._group_key = group_key
        self._lock = threading.Lock()
        # party -> (kex_scheme, prg_scheme, public bytes)
        self._peers: Dict[str, Tuple[str, str, bytes]] = {}
        self._pair_secrets: Dict[str, bytes] = {}

    # -- HELLO advertisement ---------------------------------------------------

    def hello_value(self) -> str:
        """The value published under ``wire.SECAGG_PUB_KEY`` in every
        HELLO: ``"<version>.<kex>.<prg>.<hex public bytes>"`` — the
        single producer of the format ``tool/check_wire_format.py``
        fingerprints (via :data:`SECAGG_VERSION`)."""
        return (
            f"{SECAGG_VERSION}.{self.kex_scheme}.{self.prg_scheme}."
            f"{self._pub.hex()}"
        )

    def record_peer(self, party: str, value: str) -> None:
        """Record a peer's HELLO advertisement (loop threads).

        Malformed or future-version values are logged and ignored — key
        agreement is an opportunistic rider on the handshake; the loud
        failure belongs at mask time (:meth:`pair_secret`), where the
        missing state actually bites.  A re-advertisement (peer restart
        → fresh session keypair) replaces the old record and invalidates
        the cached pair secret.
        """
        party = str(party)
        if party == self.party:
            return
        try:
            ver_s, kex, prg, hexpub = str(value).split(".", 3)
            ver = int(ver_s)
            pub = bytes.fromhex(hexpub)
        except (ValueError, TypeError):
            logger.warning(
                "[%s] ignoring malformed secagg HELLO value from %s: %r",
                self.party, party, value,
            )
            return
        if ver > SECAGG_VERSION:
            logger.warning(
                "[%s] peer %s advertises secagg v%d; this party speaks "
                "up to v%d — ignoring its key (upgrade to compose "
                "secure aggregation with it)",
                self.party, party, ver, SECAGG_VERSION,
            )
            return
        if len(pub) != 32:
            logger.warning(
                "[%s] ignoring secagg key of %d bytes from %s",
                self.party, len(pub), party,
            )
            return
        with self._lock:
            prev = self._peers.get(party)
            self._peers[party] = (kex, prg, pub)
            if prev is not None and prev[2] != pub:
                # Fresh session on the peer's side: pair secrets derived
                # from the old keypair are dead.
                self._pair_secrets.pop(party, None)
                logger.info(
                    "[%s] peer %s re-advertised a new secagg key "
                    "(restarted session)", self.party, party,
                )

    def has_peer(self, party: str) -> bool:
        with self._lock:
            return party in self._peers

    def set_group_key(self, key: bytes) -> None:
        """Provision the shared group key for the ``nonce`` fallback
        (deployment policy, like TLS certs); invalidates cached pair
        secrets so a rekey takes effect immediately."""
        with self._lock:
            self._group_key = bytes(key)
            self._pair_secrets.clear()

    def describe(self) -> Dict[str, object]:
        """Key-agreement state for ``get_stats()``: this party's suite
        plus, per peer, the scheme its recorded key arrived under."""
        with self._lock:
            return {
                "kex": self.kex_scheme,
                "prg": self.prg_scheme,
                "peers": {
                    p: f"{kex}/{prg}"
                    for p, (kex, prg, _pub) in sorted(self._peers.items())
                },
            }

    # -- pair secrets / mask seeds --------------------------------------------

    def pair_secret(self, peer: str) -> bytes:
        """The (cached) 32-byte pair secret shared with ``peer``.

        Raises :class:`SecAggError` naming the exact gap — no recorded
        peer key, mismatched schemes, or a missing group key — instead
        of ever deriving masks that cannot cancel.
        """
        peer = str(peer)
        with self._lock:
            cached = self._pair_secrets.get(peer)
            if cached is not None:
                return cached
            state = self._peers.get(peer)
        if state is None:
            raise SecAggError(
                f"no secure-aggregation key recorded for peer {peer!r} — "
                f"it has not completed a HELLO handshake with this party "
                f"(TransportManager.ensure_secagg_peer_keys pings every "
                f"peer once to establish the pair)"
            )
        kex, prg, pub = state
        if kex != self.kex_scheme or prg != self.prg_scheme:
            raise SecAggError(
                f"secure-aggregation suite mismatch with {peer!r}: this "
                f"party runs {self.kex_scheme}/{self.prg_scheme}, the "
                f"peer advertises {kex}/{prg} — masks expanded from "
                f"different suites cannot cancel.  Align the installs "
                f"(pip install 'rayfed-tpu[secagg]' everywhere) or pin "
                f"RAYFED_SECAGG_PRG on every party"
            )
        lo, hi = sorted((self.party, peer))
        lo_b, hi_b = lo.encode(), hi.encode()
        if self.kex_scheme == "x25519":
            dh = self._priv.exchange(X25519PublicKey.from_public_bytes(pub))
            lo_pub, hi_pub = (
                (self._pub, pub) if lo == self.party else (pub, self._pub)
            )
            secret = hkdf_sha256(
                dh, _lp(b"pair-secret", lo_b, hi_b, lo_pub, hi_pub)
            )
        else:
            with self._lock:
                gk = self._group_key
            if gk is None:
                raise SecAggError(
                    "secure aggregation without the 'cryptography' "
                    "package needs an operator-provisioned group key "
                    "for the nonce fallback — set RAYFED_SECAGG_GROUP_KEY "
                    "or call KeyAgreement.set_group_key(); install "
                    "'rayfed-tpu[secagg]' for the X25519 exchange that "
                    "needs no shared secret"
                )
            lo_pub, hi_pub = (
                (self._pub, pub) if lo == self.party else (pub, self._pub)
            )
            secret = hkdf_sha256(
                gk, _lp(b"pair-secret-psk", lo_b, hi_b, lo_pub, hi_pub)
            )
        with self._lock:
            self._pair_secrets[peer] = secret
        return secret

    def pair_seed(self, peer: str, *, session: str, stream: str,
                  round_index: int) -> bytes:
        """The pair's 256-bit mask seed for ONE (session, stream, round).

        Symmetric — both endpoints derive the identical seed (the pair
        is canonicalized by sorted party name; the lower-named party
        ADDS the expanded keystream, the higher-named SUBTRACTS it, so
        each pair mask appears exactly once positive and once negative
        across the parties).  Scoped by session, stream AND round: a
        failover attempt re-keys (fresh stream scope), two runs in one
        process re-key (fresh session), and revealing one round's seed
        during dropout recovery reveals no other round's (HKDF is
        one-way in the pair secret).
        """
        lo, hi = sorted((self.party, str(peer)))
        info = _lp(
            b"mask-seed", lo.encode(), hi.encode(),
            str(session).encode(), str(stream).encode(),
            int(round_index).to_bytes(8, "big"),
        )
        return hkdf_sha256(self.pair_secret(peer), info)
