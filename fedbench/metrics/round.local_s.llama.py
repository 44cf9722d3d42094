"""round.local_s.llama: the coordinator's own local steps a round
(``readings.local_s``), in the cells of the llama kind. Layer: the round
loop."""

from fedbench import readings

TRACE, UNIT, LAYER, MOVES, KIND = 1, "s", "round loop", "round_s.llama", "llama"
read = readings.local_s
