"""DataParallel and init_parallel_env (counterpart of
paddle_tpu/distributed/parallel.py:27-111).

``DataParallel`` is as thin as the reference's: one process computing
the global batch has the data-parallel contract (gradients averaged over
the dp ranks) in the mean loss's gradient already; ``scale_loss`` and
``no_sync`` keep the reference's API. Processes that each hold a part of
the batch all-reduce their gradients themselves
(``communication/ops.py``), as the reference's two-process step does;
no gradient hook is installed.

``init_parallel_env`` reads the launcher's environment
(``PADDLE_MASTER`` or ``MASTER_ADDR``, ``MASTER_PORT``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_TRAINER_ID``) and, at more than one
process, brings up a ``torch.distributed`` process group over Gloo at
``tcp://<master>``: one card cannot hold an NCCL group of two ranks, and
a world of distinct cards is item 10b's (``parallel/mesh.py`` raises
there). A failed rendezvous raises.
"""
from __future__ import annotations

import contextlib
import datetime
import os

from ..nn.layer.layers import Layer
from . import env as dist_env

# seconds a rendezvous, and then any collective, may wait for the others
DEFAULT_TIMEOUT = 600.0


class DataParallel(Layer):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self.find_unused_parameters = find_unused_parameters

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        return loss

    @contextlib.contextmanager
    def no_sync(self):
        yield

    def named_parameters(self, *args, **kwargs):
        return self._layers.named_parameters(*args, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        return self._layers.load_state_dict(*args, **kwargs)

    def set_state_dict(self, *args, **kwargs):
        return self._layers.set_state_dict(*args, **kwargs)


def get_rank(group=None):
    return group.rank() if group is not None else dist_env.get_rank()


def get_world_size(group=None):
    return group.nranks if group is not None else dist_env.get_world_size()


def init_parallel_env():
    """Join the process group the environment describes (see the module
    docstring); with one process install nothing. Marks the environment
    initialized and returns the world group."""
    import torch.distributed as dist
    master = os.environ.get("PADDLE_MASTER") or os.environ.get(
        "MASTER_ADDR")
    nprocs = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    if nprocs > 1 and not dist.is_initialized():
        if not master:
            raise RuntimeError(
                f"init_parallel_env: {nprocs} processes but no "
                f"PADDLE_MASTER / MASTER_ADDR to meet at")
        port = os.environ.get("MASTER_PORT", "8476")
        addr = master if ":" in master else f"{master}:{port}"
        timeout = float(os.environ.get("PADDLE_PG_TIMEOUT",
                                       DEFAULT_TIMEOUT))
        try:
            dist.init_process_group(
                "gloo", init_method=f"tcp://{addr}", rank=rank,
                world_size=nprocs,
                timeout=datetime.timedelta(seconds=timeout))
        except Exception as e:
            # a dead rendezvous must be loud: going on would train
            # nprocs independent replicas
            raise RuntimeError(
                f"torch.distributed.init_process_group('gloo', "
                f"init_method='tcp://{addr}', rank={rank}, world_size="
                f"{nprocs}) failed") from e
    dist_env.mark_initialized()
    from .communication.group import get_world_group
    return get_world_group()
