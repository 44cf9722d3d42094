"""device_idle.resnet: the share of the traced rounds in which no party ran an
operation on the card (``readings.device_idle``), in the cells of the resnet
kind. Layer: the device."""

from fedbench import readings

TRACE, UNIT, LAYER, MOVES, KIND = 1, "%", "device", "round_s.resnet", "resnet"
read = readings.device_idle
