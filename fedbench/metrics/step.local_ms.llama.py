"""step.local_ms.llama: mean time of a party's local step, from its
``Trainer.train`` call on the host to the card's end of the work it
returned (``spans.local_step_ms``), in the cells of the llama kind. Layer:
the local step."""

from fedbench import spans

TRACE, UNIT, LAYER, MOVES, KIND = 1, "ms", "local step", "round_s.llama", "llama"
read = spans.local_step_ms
