"""``paddle.amp.debugging`` (the port's copy of
``paddle_tpu/amp/debugging.py``).

The tensor checker toggles the op-boundary hook's nan/inf scan
(``FLAGS_check_nan_inf``, ``framework/op.py``). Operator stats fold the
hook's calls: while collection runs, an observer counts every hooked op
by name. ``compare_accuracy`` is host-only (numpy dumps).
"""
from __future__ import annotations

from contextlib import contextmanager
from enum import Enum

import torch

from ..framework import op as _op

__all__ = ["DebugMode", "TensorCheckerConfig", "enable_tensor_checker",
           "disable_tensor_checker", "check_numerics",
           "enable_operator_stats_collection",
           "disable_operator_stats_collection", "collect_operator_stats",
           "compare_accuracy"]


class DebugMode(Enum):
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL = 4


class TensorCheckerConfig:
    """Which ops to scan and what to do on a hit. As in the reference,
    only ``enable`` takes effect: every hooked op is scanned and a hit
    raises."""

    def __init__(self, enable, debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT,
                 output_dir=None, checked_op_list=None,
                 skipped_op_list=None, debug_step=None,
                 stack_height_limit=1):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir
        self.checked_op_list = list(checked_op_list or [])
        self.skipped_op_list = list(skipped_op_list or [])
        self.debug_step = debug_step
        self.stack_height_limit = stack_height_limit


def enable_tensor_checker(checker_config: TensorCheckerConfig):
    """Turn the hook's nan/inf scan on (``FLAGS_check_nan_inf``)."""
    from ..flags import set_flags
    set_flags({"FLAGS_check_nan_inf": bool(checker_config.enable)})


def disable_tensor_checker():
    from ..flags import set_flags
    set_flags({"FLAGS_check_nan_inf": False})


def check_numerics(tensor, op_type="", var_name="", debug_mode=None):
    """Scan one tensor now: ``(n_nan, n_inf)``, (0, 0) for a tensor that
    is not floating; raises on a hit."""
    a = torch.as_tensor(tensor)
    if not (a.is_floating_point() or a.is_complex()):
        return 0, 0
    n_nan = int(torch.isnan(a).sum())
    n_inf = int(torch.isinf(a).sum())
    if n_nan or n_inf:
        raise RuntimeError(
            f"check_numerics: {op_type or 'tensor'} {var_name or ''} "
            f"contains nan={n_nan} inf={n_inf} "
            f"(shape={tuple(a.shape)}, dtype={a.dtype})")
    return n_nan, n_inf


_stats = {"observer": None}


def enable_operator_stats_collection():
    """Start counting hooked op calls by name."""
    if _stats["observer"] is not None:
        _op.unwatch(_stats["observer"])
    _stats["observer"] = _op.counter()
    _op.watch(_stats["observer"])


def disable_operator_stats_collection():
    """Stop, print the per-op call counts since enable and return them."""
    obs = _stats["observer"]
    _stats["observer"] = None
    if obs is None:
        return {}
    _op.unwatch(obs)
    counts = obs.counts
    print("<------------------------------ op list "
          "------------------------------->")
    for name, n in counts.most_common():
        print(f"  {name:<40} calls={n}")
    print("<----------------------------------- done "
          "----------------------------->")
    return dict(counts)


@contextmanager
def collect_operator_stats():
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection()


def compare_accuracy(dump_path, another_dump_path, output_filename,
                     loss_scale=1, dump_all_tensors=False):
    """Offline comparison of two runs' tensor dumps (``numpy.save``
    files of the same name): one CSV row per shared file."""
    import csv
    import os

    import numpy as np
    rows = []
    for name in sorted(os.listdir(dump_path)):
        other = os.path.join(another_dump_path, name)
        if not name.endswith(".npy") or not os.path.exists(other):
            continue
        a = np.load(os.path.join(dump_path, name))
        b = np.load(other)
        if a.shape != b.shape:
            rows.append((name, f"shape-mismatch {a.shape}->{b.shape}",
                         "", ""))
            continue
        diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
        rows.append((name, float(diff.max()), float(diff.mean()),
                     bool(np.isnan(a).any() or np.isnan(b).any())))
    with open(output_filename, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["tensor", "max_diff", "mean_diff", "has_nan"])
        w.writerows(rows)
    return rows
