"""round_s.resnet: the window's wall time over the whole rounds completed in
it: what a cross-silo job pays per round (``readings.round_s``), in the
cells of the resnet kind, whose rounds the shared host paces."""

from fedbench import readings

TRACE, UNIT, KIND = 0, "s", "resnet"
read = readings.round_s
