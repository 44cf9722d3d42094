"""agg.host_ms.resnet: the coordinator's staging, fold launches and finalize a
round, without the wait for bytes (``spans.agg_host_ms``), in the cells of
the resnet kind. Layer: the codec and fold."""

from fedbench import spans

TRACE, UNIT, LAYER, MOVES, KIND = 1, "ms", "codec and fold", "round_s.resnet", "resnet"
read = spans.agg_host_ms
