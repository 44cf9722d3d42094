"""wire.send_ms.resnet: mean wire.send span (``readings.send_ms``), in the
cells of the resnet kind. Layer: the transport."""

from fedbench import readings

TRACE, UNIT, LAYER, MOVES, KIND = 1, "ms", "transport", "round_s.resnet", "resnet"
read = readings.send_ms
