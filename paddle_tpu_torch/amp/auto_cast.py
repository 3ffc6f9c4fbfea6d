"""AMP autocast (the port's copy of ``paddle_tpu/amp/auto_cast.py``).

O1: the inputs of white-list ops are cast to the amp dtype, those of
black-list ops to float32, every other op runs in the incoming dtype.
O2: every floating input is cast to the amp dtype except at black-list
ops. OD is O1's rule. ``maybe_cast_inputs`` is the rule
(``paddle_tpu/amp/auto_cast.py:117-137``); the op-boundary hook
(``framework/op.py`` ``op_inputs``) applies it at every op of the port's
training paths under the JAX package's op names. The lists are Paddle's,
not ``torch.autocast``'s: LayerNorm stays in the amp dtype (its
statistics are float32 inside the op), and custom lists move names
between them.
"""
from __future__ import annotations

import threading

import torch

from ..framework.dtype import convert_dtype

__all__ = ["BLACK_LIST", "WHITE_LIST", "amp_global_state", "amp_guard",
           "amp_state", "auto_cast", "decorate", "maybe_cast_inputs"]

WHITE_LIST = {
    "conv2d", "conv1d", "conv3d", "conv2d_transpose", "matmul", "matmul_v2",
    "mul", "bmm", "einsum", "linear", "fc", "attention", "flash_attention",
}
BLACK_LIST = {
    "exp", "square", "log", "mean", "sum", "cos_sim",
    "softmax", "log_softmax", "softmax_with_cross_entropy",
    "sigmoid_cross_entropy_with_logits", "c_softmax_with_cross_entropy",
    "cross_entropy", "cross_entropy2", "reduce_sum",
    "batch_norm", "instance_norm",
    "lookup_table", "lookup_table_v2", "scatter",
    "linear_interp_v2", "nearest_interp_v2", "bilinear_interp_v2",
    "bicubic_interp_v2", "trilinear_interp_v2",
}

_AMP_DTYPES = (torch.bfloat16, torch.float16, torch.float32)


def _amp_dtype(dtype):
    """The torch dtype of an amp dtype (bfloat16, float16 or float32)."""
    d = convert_dtype(dtype)
    if d not in _AMP_DTYPES:
        raise ValueError(f"unsupported amp dtype {dtype!r}")
    return d


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = None
        self.level = "O1"
        self.white = WHITE_LIST
        self.black = BLACK_LIST


_state = _AmpState()


def amp_state():
    return _state


def amp_global_state():
    return _state


class auto_cast:
    """``with auto_cast(enable=True, level='O1', dtype='bfloat16'):`` —
    the thread's amp state for the block (restored on exit)."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16",
                 use_promote=True):
        if level not in ("O0", "O1", "O2", "OD"):
            raise ValueError(f"unsupported amp level {level}")
        self._enable = enable and level != "O0"
        self._level = level
        self._dtype = _amp_dtype(dtype)
        self._white = set(WHITE_LIST)
        self._black = set(BLACK_LIST)
        if custom_white_list:
            self._white |= set(custom_white_list)
            self._black -= set(custom_white_list)
        if custom_black_list:
            self._black |= set(custom_black_list)
            self._white -= set(custom_black_list)

    def __enter__(self):
        self._saved = (_state.enabled, _state.dtype, _state.level,
                       _state.white, _state.black)
        _state.enabled = self._enable
        _state.dtype = self._dtype
        _state.level = self._level
        _state.white = self._white
        _state.black = self._black
        return self

    def __exit__(self, *exc):
        (_state.enabled, _state.dtype, _state.level,
         _state.white, _state.black) = self._saved
        return False


amp_guard = auto_cast


def _cast(t, dtype):
    """``t`` in ``dtype`` when it is a floating tensor of another dtype;
    anything else (ints, None, Python numbers) as it is."""
    if not isinstance(t, torch.Tensor) or not t.is_floating_point() \
            or t.dtype == dtype:
        return t
    return t.to(dtype)


def maybe_cast_inputs(op_name, tensor_args):
    """The inputs of one application of ``op_name`` under the thread's
    amp state (``cast`` itself is exempt)."""
    if not _state.enabled or op_name is None or op_name == "cast":
        return tensor_args
    if _state.level in ("O1", "OD"):
        if op_name in _state.white:
            return [_cast(t, _state.dtype) for t in tensor_args]
        if op_name in _state.black:
            return [_cast(t, torch.float32) for t in tensor_args]
        return tensor_args
    if op_name in _state.black:
        return [_cast(t, torch.float32) for t in tensor_args]
    return [_cast(t, _state.dtype) for t in tensor_args]


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2 casts every floating parameter of ``models`` to the amp dtype in
    place: each ``Parameter`` object stays (``p.data`` is replaced), so an
    optimizer's parameter list and a tied weight still see it. Buffers
    keep their dtype, as in the reference. ``master_weight`` and
    ``save_dtype`` are accepted and unused, as in the reference (the
    optimizer's ``multi_precision`` keeps the masters)."""
    d = _amp_dtype(dtype)
    single_model = not isinstance(models, (list, tuple))
    model_list = [models] if single_model else list(models)
    if level == "O2":
        with torch.no_grad():
            for m in model_list:
                for p in m.parameters():
                    if p.is_floating_point() and p.dtype != d:
                        p.data = p.data.to(d)
    if optimizers is None:
        return models if single_model else model_list
    return (models if single_model else model_list), optimizers
