"""paddle.distributed.rpc (counterpart of paddle_tpu/distributed/rpc/
__init__.py)."""
from .rpc import (WorkerInfo, get_all_worker_infos,  # noqa: F401
                  get_current_worker_info, get_worker_info, init_rpc,
                  rpc_async, rpc_sync, shutdown)

__all__ = ["init_rpc", "rpc_sync", "rpc_async", "shutdown",
           "get_worker_info", "get_all_worker_infos",
           "get_current_worker_info", "WorkerInfo"]
