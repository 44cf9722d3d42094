"""round.exchange_s.llama: the exchange and fold a round waits for past the
coordinator's local steps (``readings.exchange_s``), in the cells of the
llama kind. Layer: the round loop."""

from fedbench import readings

TRACE, UNIT, LAYER, MOVES, KIND = 1, "s", "round loop", "round_s.llama", "llama"
read = readings.exchange_s
