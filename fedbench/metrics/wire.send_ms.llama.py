"""wire.send_ms.llama: mean wire.send span (``readings.send_ms``), in the cells
of the llama kind. Layer: the transport."""

from fedbench import readings

TRACE, UNIT, LAYER, MOVES, KIND = 1, "ms", "transport", "round_s.llama", "llama"
read = readings.send_ms
