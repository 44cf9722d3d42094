"""Cross-party failure types.

The reference swallows a failed cross-silo send into ``False`` plus a log
line (``fed/barriers.py:244-248``) and the consumer side never learns why
its ``recv`` hangs.  SURVEY §7 sets "replicate, then improve (surfacing
errors on ``get``)" as the goal; :class:`RemoteError` is the improvement:
when a producer party's task raises (or its payload fails to encode), the
producer pushes a compact poison message to every rendezvous key it had
promised, and the consumer's ``fed.get`` raises this error within the
transport round-trip time instead of parking until the recv backstop.
"""

from __future__ import annotations

from typing import Optional, Sequence


class PartyWaitTimeout(TimeoutError):
    """A bounded wait on other parties expired, naming who was missing.

    Raised by deadline-bounded cross-party waits (streaming-aggregation
    sinks, quorum cutoffs that cannot reach *k*, parked recvs) instead
    of a bare ``TimeoutError`` — the first question at 3am is always
    "which party", so the exception answers it.
    """

    def __init__(self, message: str,
                 missing_parties: Optional[Sequence[str]] = None) -> None:
        self.missing_parties = sorted(missing_parties or [])
        if self.missing_parties:
            message = f"{message} (missing parties: {self.missing_parties})"
        super().__init__(message)


class RemoteError(RuntimeError):
    """A task in another party failed; raised on the consumer's ``fed.get``.

    Attributes:
        party: the party whose task (or encode step) failed.
        exc_type: the remote exception's class name, e.g. ``"ValueError"``.
        message: the remote exception's ``str()``.
    """

    def __init__(self, party: str, exc_type: str, message: str,
                 traceback_str: Optional[str] = None) -> None:
        self.party = party
        self.exc_type = exc_type
        self.message = message
        self.traceback_str = traceback_str
        detail = f"[{party}] {exc_type}: {message}"
        if traceback_str:
            detail += f"\n--- remote traceback ({party}) ---\n{traceback_str}"
        super().__init__(detail)

    def to_wire(self) -> dict:
        d = {"party": self.party, "type": self.exc_type, "msg": self.message}
        if self.traceback_str:
            d["tb"] = self.traceback_str
        return d

    @classmethod
    def from_wire(cls, d: dict) -> "RemoteError":
        return cls(
            party=str(d.get("party", "?")),
            exc_type=str(d.get("type", "Exception")),
            message=str(d.get("msg", "")),
            traceback_str=d.get("tb"),
        )

    @classmethod
    def from_exception(cls, party: str, exc: BaseException) -> "RemoteError":
        import traceback

        tb = None
        if exc.__traceback__ is not None:
            tb = "".join(
                traceback.format_exception(type(exc), exc, exc.__traceback__)
            )
            # Bound the wire size: a deep traceback is diagnostics, not data.
            if len(tb) > 16384:
                tb = tb[-16384:]
        return cls(party, type(exc).__name__, str(exc), tb)
