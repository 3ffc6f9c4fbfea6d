"""paddle.distributed.sharding (counterpart of paddle_tpu/distributed/
sharding/__init__.py)."""
from ..fleet.meta_parallel.sharding import (  # noqa: F401
    group_sharded_parallel, save_group_sharded_model)
