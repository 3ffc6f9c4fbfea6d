"""paddle.distributed.fleet (counterpart of paddle_tpu/distributed/
fleet/__init__.py): ``init`` and its HybridCommunicateGroup, the
wrappers, and the mpu layers under ``meta_parallel`` and
``layers.mpu``."""
from . import meta_parallel  # noqa: F401
from .fleet import (  # noqa: F401
    HybridParallelOptimizer, PaddleCloudRoleMaker, UserDefinedRoleMaker,
    barrier_worker, distributed_model, distributed_optimizer, init,
    is_first_worker, is_initialized, worker_index, worker_num)
from .layers import mpu  # noqa: F401
from .strategy import DistributedStrategy  # noqa: F401
from .topology import (  # noqa: F401
    CommunicateTopology, HybridCommunicateGroup,
    get_hybrid_communicate_group)
