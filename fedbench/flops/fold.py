"""Bytes of the round's fold on the packed wire (``fold_fma.cu``).

The least a round's fold needs: every contribution read once and the
aggregate written once, ``(parties + 1) · elements · wire bytes``.  The
forms' own counts, for comparison: a streamed step reads and writes the
float32 accumulator and reads one bfloat16 operand (10 B an element), the
finalize reads the accumulator and writes the bfloat16 result (6 B), a
chain of ``n`` operands reads each and writes the result.
"""

from __future__ import annotations

ACC, WIRE = 4, 2


def round_bytes(parties: int, elems: int, wire: int = WIRE) -> int:
    return (parties + 1) * elems * wire


def step_bytes(elems: int) -> int:
    return (2 * ACC + WIRE) * elems


def finalize_bytes(elems: int) -> int:
    return (ACC + WIRE) * elems


def chain_bytes(n: int, elems: int) -> int:
    return (n + 1) * WIRE * elems
