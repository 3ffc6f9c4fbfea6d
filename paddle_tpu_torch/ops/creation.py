"""Tensor creation ops (counterpart of ``paddle_tpu/ops/creation.py``).

New tensors go to the current device (``framework/device.py``); the
``*_like`` ops go where their input is. The random ops draw from
torch's generator of the target device, which ``paddle.seed``
(``framework/random.py``) seeds; their draws cannot equal the JAX
package's, so the op specs hold them by their moments.
"""
from __future__ import annotations

import numpy as np
import torch

from ._helpers import (Tensor, apply, convert_dtype, get_default_dtype,
                       long, op, unwrap, wrap)
from ..framework.device import current_device
from ..framework.tensor import to_tensor  # re-export

__all__ = [
    "to_tensor", "zeros", "ones", "full", "empty", "zeros_like", "ones_like",
    "full_like", "empty_like", "arange", "linspace", "logspace", "eye",
    "diag", "diagflat", "meshgrid", "tril", "triu", "tril_indices",
    "triu_indices", "rand", "randn", "randint", "randint_like", "randperm",
    "uniform", "normal", "standard_normal", "bernoulli", "multinomial",
    "poisson", "assign", "clone", "one_hot", "complex", "numel", "diag_embed",
    "uniform_", "normal_", "exponential_", "polar", "create_parameter",
]


def _shape(shape):
    if isinstance(shape, Tensor):
        shape = shape.numpy()
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(unwrap(s) if isinstance(s, Tensor) else s)
                 for s in shape)


def _dt(dtype, default=None):
    d = convert_dtype(dtype)
    return d if d is not None else (default or get_default_dtype())


def _new(fn, shape, dtype, **kw):
    return wrap(fn(_shape(shape), dtype=_dt(dtype), device=current_device(),
                   **kw))


def zeros(shape, dtype=None, name=None):
    return _new(torch.zeros, shape, dtype)


def ones(shape, dtype=None, name=None):
    return _new(torch.ones, shape, dtype)


def full(shape, fill_value, dtype=None, name=None):
    if isinstance(fill_value, Tensor):
        fill_value = fill_value.item()
    d = convert_dtype(dtype)
    if d is None and isinstance(fill_value, float):
        d = get_default_dtype()
    return wrap(torch.full(_shape(shape), fill_value, dtype=d,
                           device=current_device()))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def zeros_like(x, dtype=None, name=None):
    return wrap(torch.zeros_like(unwrap(x), dtype=convert_dtype(dtype)))


def ones_like(x, dtype=None, name=None):
    return wrap(torch.ones_like(unwrap(x), dtype=convert_dtype(dtype)))


def full_like(x, fill_value, dtype=None, name=None):
    return wrap(torch.full_like(unwrap(x), fill_value,
                                dtype=convert_dtype(dtype)))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def _scalar(v):
    if isinstance(v, Tensor):
        return v.item()
    return v


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if dtype is None:
        dtype = torch.float32 if any(
            isinstance(v, float) for v in (start, end, step)) \
            else torch.int64
    if end is None:
        start, end = 0, start
    return wrap(torch.arange(start, end, step, dtype=convert_dtype(dtype),
                             device=current_device()))


def linspace(start, stop, num, dtype=None, name=None):
    return wrap(torch.linspace(_scalar(start), _scalar(stop),
                               int(_scalar(num)), dtype=_dt(dtype),
                               device=current_device()))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return wrap(torch.logspace(_scalar(start), _scalar(stop),
                               int(_scalar(num)), base=base,
                               dtype=_dt(dtype), device=current_device()))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    n = int(num_rows)
    m = n if num_columns is None else int(num_columns)
    return wrap(torch.eye(n, m, dtype=_dt(dtype), device=current_device()))


def diag(x, offset=0, padding_value=0, name=None):
    def impl(a):
        if a.ndim == 1:
            d = torch.diag(a, offset)
            if padding_value != 0:
                mask = torch.ones(a.shape[0], dtype=torch.bool,
                                  device=a.device).diag(offset)
                d = torch.where(mask, d, padding_value)
            return d
        return torch.diagonal(a, offset)
    return op("diag", impl, x)


def diagflat(x, offset=0, name=None):
    return op("diagflat", lambda a: torch.diagflat(a, offset), x)


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    return op("diag_embed",
              lambda a: torch.diag_embed(a, offset, dim1, dim2), x)


def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    return list(apply(lambda *xs: torch.meshgrid(*xs, indexing="ij"), args))


def tril(x, diagonal=0, name=None):
    return op("tril", lambda a: torch.tril(a, diagonal), x)


def triu(x, diagonal=0, name=None):
    return op("triu", lambda a: torch.triu(a, diagonal), x)


def tril_indices(row, col=None, offset=0, dtype="int64"):
    col = row if col is None else col
    return wrap(torch.tril_indices(row, col, offset,
                                   device=current_device()).to(
        convert_dtype(dtype)))


def triu_indices(row, col=None, offset=0, dtype="int64"):
    col = row if col is None else col
    return wrap(torch.triu_indices(row, col, offset,
                                   device=current_device()).to(
        convert_dtype(dtype)))


# -- random ----------------------------------------------------------------

def rand(shape, dtype=None, name=None):
    return _new(torch.rand, shape, dtype)


def randn(shape, dtype=None, name=None):
    return _new(torch.randn, shape, dtype)


standard_normal = randn


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    return wrap(torch.randint(low, high, _shape(shape),
                              dtype=convert_dtype(dtype),
                              device=current_device()))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    a = unwrap(x)
    return wrap(torch.randint(low, high, tuple(a.shape),
                              dtype=convert_dtype(dtype) or a.dtype,
                              device=a.device))


def randperm(n, dtype="int64", name=None):
    return wrap(torch.randperm(int(n), device=current_device()).to(
        convert_dtype(dtype)))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev = current_device()
    g = torch.Generator(device=dev).manual_seed(seed) if seed else None
    u = torch.rand(_shape(shape), dtype=_dt(dtype), device=dev, generator=g)
    return wrap(u * (max - min) + min)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        m, s = unwrap(mean), unwrap(std)
        ref = m if isinstance(m, torch.Tensor) else s
        sh = torch.broadcast_shapes(*(v.shape for v in (m, s)
                                      if isinstance(v, torch.Tensor)))
        return wrap(m + s * torch.randn(sh, dtype=ref.dtype,
                                        device=ref.device))
    sh = _shape(shape) if shape is not None else ()
    return wrap(mean + std * torch.randn(sh, dtype=get_default_dtype(),
                                         device=current_device()))


def bernoulli(x, name=None):
    return wrap(torch.bernoulli(unwrap(x).detach()))


def multinomial(x, num_samples=1, replacement=False, name=None):
    return wrap(torch.multinomial(unwrap(x).detach(), num_samples,
                                  replacement))


def poisson(x, name=None):
    return wrap(torch.poisson(unwrap(x).detach()))


def _fill_random(x, draw):
    """Overwrite ``x`` in place with a random draw (no gradient)."""
    from ..framework.op import check_inplace
    check_inplace(x)
    with torch.no_grad():
        draw(x._data)
    return x


def uniform_(x, min=-1.0, max=1.0, name=None):
    return _fill_random(x, lambda t: t.uniform_(min, max))


def normal_(x, mean=0.0, std=1.0, name=None):
    return _fill_random(x, lambda t: t.normal_(mean, std))


def exponential_(x, lam=1.0, name=None):
    return _fill_random(x, lambda t: t.exponential_(lam))


# -- misc ------------------------------------------------------------------

def assign(x, output=None):
    data = unwrap(x) if isinstance(x, Tensor) else \
        torch.as_tensor(np.asarray(x), device=current_device())
    if output is None:
        return wrap(data)
    return output.set_value(data)


def clone(x, name=None):
    return op("clone", torch.clone, x)


def one_hot(x, num_classes, name=None):
    return wrap(torch.nn.functional.one_hot(
        long(unwrap(x)), num_classes).to(get_default_dtype()))


def complex(real, imag, name=None):
    return op("complex", torch.complex, real, imag)


def numel(x, name=None):
    a = unwrap(x)
    return wrap(torch.tensor(a.numel(), device=a.device))


def polar(abs, angle, name=None):
    """A complex tensor from polar coordinates: abs * (cos + i sin)."""
    return apply(torch.polar, (abs, angle), op_name="polar")


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A ``Parameter`` handle drawn by ``default_initializer``, else
    ``attr``'s initializer, else zeros for a bias and Xavier-normal for a
    weight, on the current device."""
    from ..framework.tensor import Parameter
    from ..nn import initializer as I
    init = default_initializer
    if init is None and attr is not None and \
            getattr(attr, "initializer", None) is not None:
        init = attr.initializer
    if init is None:
        init = I.Constant(0.0) if is_bias else I.XavierNormal()
    data = init(list(_shape(shape)), convert_dtype(dtype),
                device=current_device())
    return Parameter(data, name=name or (getattr(attr, "name", None)
                                         if attr is not None else None))
