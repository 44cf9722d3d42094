"""peak_mem_gib.llama: the highest card memory any party process allocated over
the run: whether a silo's card holds the job (``readings.peak_mem_gib``), in
the cells of the llama kind, whose rounds the card paces."""

from fedbench import readings

TRACE, UNIT, KIND = 0, "GiB", "llama"
read = readings.peak_mem_gib
