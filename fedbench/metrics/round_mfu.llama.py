"""round_mfu.llama: every party's model FLOPs over the traced rounds' wall and
the bfloat16 peak (``readings.mfu``), in the cells of the llama kind. Layer:
the local step."""

from fedbench import readings

TRACE, UNIT, LAYER, MOVES, KIND = 1, "%", "local step", "round_s.llama", "llama"
read = readings.mfu
