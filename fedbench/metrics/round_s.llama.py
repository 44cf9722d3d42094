"""round_s.llama: the window's wall time over the whole rounds completed in it:
what a cross-silo job pays per round (``readings.round_s``), in the cells of
the llama kind, whose rounds the card paces."""

from fedbench import readings

TRACE, UNIT, KIND = 0, "s", "llama"
read = readings.round_s
