"""Plain fold of a round over the packed bfloat16 wire: the equal-weight mean.

Each contribution is widened to float32 and added in party order, the sum
divided by the party count, and the result rounded to bfloat16 to nearest
even.  Subnormal inputs and results flush to a zero of their sign, as the
round's float programs do.
"""

from __future__ import annotations

import torch

TINY = 2.0**-126


def _flush(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x.abs() < TINY, x * 0, x)


def fold(uploads: list) -> torch.Tensor:
    acc = _flush(uploads[0].float())
    for x in uploads[1:]:
        acc = _flush(acc + _flush(x.float()))
    return _flush(acc / float(len(uploads))).to(torch.bfloat16)
