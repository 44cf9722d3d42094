"""wire_mb_per_round: payload bytes that all parties' transports sent in
the window (``send_payload_bytes``), over its rounds, in 1e6 bytes."""

TRACE, UNIT = 0, "MB"


def read(ctx):
    w = ctx["window"]
    sent = sum(r["marks"][w["r1"]][1] - r["marks"][w["r0"]][1] for r in ctx["reports"].values())
    return sent / w["rounds"] / 1e6
