"""peak_mem_gib.resnet: the highest card memory any party process allocated
over the run: whether a silo's card holds the job
(``readings.peak_mem_gib``), in the cells of the resnet kind, whose rounds
the shared host paces."""

from fedbench import readings

TRACE, UNIT, KIND = 0, "GiB", "resnet"
read = readings.peak_mem_gib
