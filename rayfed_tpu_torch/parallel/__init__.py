"""Party-local parallelism: meshes, sharding strategies, collectives.

The port of ``rayfed_tpu/parallel``.  Each party's compute may span a world
of ranks (one process per rank, started by
:func:`~rayfed_tpu_torch.parallel.collectives.init_world`); a
``DeviceMesh`` over them (:func:`create_mesh`) names the axes
(DP / FSDP / TP / SP / EP / PP) and a :class:`ShardingStrategy` says how a
task's params and batch map onto them; the pipeline schedules
(:mod:`~rayfed_tpu_torch.parallel.pipeline`: GPipe, 1F1B, interleaved)
split a stacked layer tree over ``pp``.
"""

from rayfed_tpu_torch.parallel.mesh import (
    AXIS_DP,
    AXIS_EP,
    AXIS_FSDP,
    AXIS_PP,
    AXIS_SP,
    AXIS_TP,
    create_mesh,
)
from rayfed_tpu_torch.parallel.pipeline import (
    make_pipeline,
    make_pipeline_train,
    pipeline_collective,
    stack_params,
)
from rayfed_tpu_torch.parallel.sharding import ShardingStrategy

__all__ = [
    "create_mesh",
    "ShardingStrategy",
    "make_pipeline",
    "make_pipeline_train",
    "pipeline_collective",
    "stack_params",
    "AXIS_DP",
    "AXIS_FSDP",
    "AXIS_TP",
    "AXIS_SP",
    "AXIS_EP",
    "AXIS_PP",
]
