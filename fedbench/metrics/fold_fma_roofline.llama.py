"""fold_fma_roofline.llama: the fold kernels' least time at the HBM peak over
their device time (``readings.fold_roofline``), in the cells of the llama
kind. Layer: the codec and fold."""

from fedbench import readings

TRACE, UNIT, LAYER, MOVES, KIND = 1, "%", "codec and fold", "round_s.llama", "llama"
read = readings.fold_roofline
