"""fold_fma_roofline.resnet: the fold kernels' least time at the HBM peak over
their device time (``readings.fold_roofline``), in the cells of the resnet
kind. Layer: the codec and fold."""

from fedbench import readings

TRACE, UNIT, LAYER, MOVES, KIND = 1, "%", "codec and fold", "round_s.resnet", "resnet"
read = readings.fold_roofline
