"""MoE token dispatch by counts (counterpart of paddle_tpu/distributed/
utils/moe_utils.py:1-80): ``global_scatter`` / ``global_gather`` with
the reference's single-process semantics. The counts define a
permutation: ``local_count[i]`` consecutive rows of ``x`` go to expert
``i``, taken in expert order, and ``global_gather`` is the inverse. One
process holds every rank, so no rows move between processes; the
capacity-padded expert-parallel dispatch is ``incubate.moe.MoELayer``'s.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["global_scatter", "global_gather"]


def _order(local_count):
    lc = np.asarray(local_count.detach().cpu().numpy()
                    if isinstance(local_count, torch.Tensor)
                    else local_count).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(lc)[:-1]])
    return np.concatenate([np.arange(s, s + c) for s, c in
                           zip(starts, lc)] + [np.zeros(0, np.int64)])


def global_scatter(x, local_count, global_count, group=None,
                   use_calc_stream=True):
    """The rows of ``x`` in expert order."""
    idx = torch.from_numpy(_order(local_count)).to(x.device)
    return x[idx]


def global_gather(x, local_count, global_count, group=None,
                  use_calc_stream=True):
    """The inverse permutation of ``global_scatter``."""
    order = _order(local_count)
    inv = np.empty_like(order)
    inv[order] = np.arange(order.size)
    return x[torch.from_numpy(inv).to(x.device)]
