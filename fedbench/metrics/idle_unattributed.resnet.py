"""idle_unattributed.resnet: the share of the card's idle time in the traced
rounds that no party's span of work covers (``spans.idle_unattributed``),
in the cells of the resnet kind. Layer: the device."""

from fedbench import spans

TRACE, UNIT, LAYER, MOVES, KIND = 1, "%", "device", "round_s.resnet", "resnet"
read = spans.idle_unattributed
