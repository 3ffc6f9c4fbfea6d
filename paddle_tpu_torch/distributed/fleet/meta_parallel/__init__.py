"""The hybrid-parallel wrappers and the mpu layers' re-exports
(counterpart of paddle_tpu/distributed/fleet/meta_parallel/
__init__.py). The pipeline wrappers, ``pp_layers`` and the sharding
optimizers wait for ROADMAP Queue A item 11b."""
from ..layers.mpu.mp_layers import (ColumnParallelLinear,  # noqa: F401
                                    ParallelCrossEntropy, RowParallelLinear,
                                    VocabParallelEmbedding)
from ..layers.mpu.random import get_rng_state_tracker  # noqa: F401
from .meta_parallel_base import (  # noqa: F401
    MetaParallelBase, ShardingParallel, TensorParallel)
