"""wire.transfer_ms.llama: mean wire.send span less the sender's waits for the
card inside it (``spans.transfer_ms``), in the cells of the llama kind.
Layer: the transport."""

from fedbench import spans

TRACE, UNIT, LAYER, MOVES, KIND = 1, "ms", "transport", "round_s.llama", "llama"
read = spans.transfer_ms
