"""The plain references: float32 PyTorch with TF32 off, one file per model
kind (``<kind>.py``, with ``follow(job, device)``) and one per fold form
(``<fold>.py``, with ``fold(uploads)``).  They import nothing of the program
and take only what ``fedbench.traffic`` makes from the seed; whatever the
program derived from those inputs they work out again.
"""

import torch


def full_precision() -> None:
    """float32 matmuls and convolutions in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def wire_round_trip(tree):
    """A tree as the packed bfloat16 wire hands it to a trainer: each float
    leaf rounded to bfloat16 and widened back to float32."""
    if isinstance(tree, dict):
        return {k: wire_round_trip(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(wire_round_trip(v) for v in tree)
    return tree.to(torch.bfloat16).float()
