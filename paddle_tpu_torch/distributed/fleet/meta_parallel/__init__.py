"""The hybrid-parallel wrappers and the mpu layers' re-exports
(counterpart of paddle_tpu/distributed/fleet/meta_parallel/
__init__.py): the tensor-, sharding- and pipeline-parallel wrappers,
``PipelineLayer`` with its descriptors, and the ZeRO optimizers."""
from ..layers.mpu.mp_layers import (ColumnParallelLinear,  # noqa: F401
                                    ParallelCrossEntropy, RowParallelLinear,
                                    VocabParallelEmbedding)
from ..layers.mpu.random import get_rng_state_tracker  # noqa: F401
from .meta_parallel_base import (  # noqa: F401
    MetaParallelBase, ShardingParallel, TensorParallel)
from .pipeline_parallel import (  # noqa: F401
    PipelineParallel, PipelineParallelWithInterleave)
from .pp_layers import LayerDesc, PipelineLayer, SharedLayerDesc  # noqa: F401
from .sharding import (  # noqa: F401
    DygraphShardingOptimizer, GroupShardedOptimizerStage2,
    GroupShardedStage2, GroupShardedStage3, group_sharded_parallel,
    save_group_sharded_model)
