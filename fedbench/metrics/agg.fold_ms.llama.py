"""agg.fold_ms.llama: the coordinator's fold and finalize spans a round
(``readings.fold_ms``), in the cells of the llama kind. Layer: the codec and
fold."""

from fedbench import readings

TRACE, UNIT, LAYER, MOVES, KIND = 1, "ms", "codec and fold", "round_s.llama", "llama"
read = readings.fold_ms
