"""Published peaks of the cards the benchmark runs on, by device name.

NVIDIA's data sheet of the H100 SXM part (the card that names itself
"NVIDIA H100 80GB HBM3"): 989 TFLOP/s dense bfloat16 on the tensor cores,
3.35 TB/s of HBM.  A card missing here has no peak: a share of an invented
one is no number, so the readers that need it report nothing.
"""

from __future__ import annotations

FLOPS_BF16 = {"H100 80GB HBM3": 989e12}
HBM_BYTES_PER_S = {"H100 80GB HBM3": 3.35e12}


def lookup(table: dict, kind: str):
    for name, peak in table.items():
        if name.lower() in kind.lower():
            return peak
    return None
