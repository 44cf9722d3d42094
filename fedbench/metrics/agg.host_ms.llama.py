"""agg.host_ms.llama: the coordinator's staging, fold launches and finalize a
round, without the wait for bytes (``spans.agg_host_ms``), in the cells of
the llama kind. Layer: the codec and fold."""

from fedbench import spans

TRACE, UNIT, LAYER, MOVES, KIND = 1, "ms", "codec and fold", "round_s.llama", "llama"
read = spans.agg_host_ms
