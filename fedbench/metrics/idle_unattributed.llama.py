"""idle_unattributed.llama: the share of the card's idle time in the traced
rounds that no party's span of work covers (``spans.idle_unattributed``),
in the cells of the llama kind. Layer: the device."""

from fedbench import spans

TRACE, UNIT, LAYER, MOVES, KIND = 1, "%", "device", "round_s.llama", "llama"
read = spans.idle_unattributed
