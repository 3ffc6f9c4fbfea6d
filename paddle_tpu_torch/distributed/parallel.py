"""DataParallel (counterpart of paddle_tpu/distributed/parallel.py:27-111).

As thin as the reference's: one process computes the global batch, so
the data-parallel contract (gradients averaged over the dp ranks) is the
mean loss's gradient already; ``scale_loss`` and ``no_sync`` keep the
reference's API.
"""
from __future__ import annotations

import contextlib

from ..nn.layer.layers import Layer
from . import env as dist_env


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
