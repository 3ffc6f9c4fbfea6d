"""Paddle's ``Tensor``: a mutable handle whose ``_data`` is a
``torch.Tensor`` (counterpart of ``paddle_tpu/framework/tensor.py``).

The surface is the reference's (``tensor.py:24-288``): ``shape`` as a
list, ``dtype``, ``ndim``, ``size``, ``T``, ``place``, ``numpy`` /
``item`` / ``tolist``, ``astype`` / ``cast``, ``detach``, ``clone``,
``set_value`` / ``copy_`` / ``fill_`` / ``zero_``, ``cuda`` / ``cpu`` /
``to``, indexing and the Python protocol. The math, manipulation and
comparison methods and the arithmetic dunders are installed from
``ops`` (``ops.install_tensor_methods``), as the reference installs
them.

Autograd is torch's: ``stop_gradient`` is ``not _data.requires_grad``
(setting it True on a tensor an op produced detaches it, as Paddle
does), ``grad`` is a handle over ``_data.grad``, ``register_hook`` and
``retain_grads`` go to the torch tensor's. Mutation works on ``_data``
in place (``set_value`` / ``copy_`` / ``fill_`` under ``no_grad``), so
hooks and leaves survive it; an in-place op on a leaf that needs a
gradient raises, as in Paddle (``framework/op.py`` ``apply_inplace``).

The handle is not a ``torch.Tensor`` and has no ``__torch_function__``:
``transpose(perm)``, ``size``, ``split(num_or_sections)`` and the rest
keep Paddle's meaning, and a torch function handed a handle raises. A
64-bit type is narrowed when a Tensor is made (``dtype.canonical``), as
in the JAX package; ``numpy()`` of a bfloat16 tensor gives its float32
values (numpy has no bfloat16).
"""
from __future__ import annotations

import builtins
import itertools

import numpy as np
import torch

from . import autograd
from ..device import resolve_device
from .device import Place, current_device, parse_place, place_of
from .dtype import canonical, convert_dtype, dtype_name, get_default_dtype

__all__ = ["Parameter", "Tensor", "to_tensor"]

_names = itertools.count(1)


def _host_to_torch(data, dtype, device):
    """A torch tensor holding a copy of Python / numpy ``data`` (Paddle's
    rules: float data without a dtype takes the default dtype)."""
    if isinstance(data, np.ndarray) and data.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(data).view(np.int16)) \
            .view(torch.bfloat16)
    else:
        a = np.asarray(data)
        if dtype is None and a.dtype == np.float64 and \
                not isinstance(data, np.ndarray):
            dtype = get_default_dtype()
        if a.dtype.kind in "US" or a.dtype == object:
            raise TypeError(f"cannot make a Tensor of {type(data).__name__}")
        t = torch.from_numpy(np.array(a))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def _grad_dtype(t):
    return t.is_floating_point() or t.is_complex()


class Tensor:
    __slots__ = ("_data", "_name", "persistable", "trainable",
                 "is_distributed", "_dist_attr", "main_grad",
                 "__weakref__")

    def __init__(self, data, dtype=None, stop_gradient=True, name=None, *,
                 place=None):
        dtype = convert_dtype(dtype)
        if isinstance(data, Tensor):
            data = data._data
        if not isinstance(data, torch.Tensor):
            dev = place.torch_device() if place is not None \
                else current_device()
            data = _host_to_torch(data, dtype, dev)
        elif place is not None:
            data = data.to(place.torch_device())
        data = data.to(canonical(data.dtype if dtype is None else dtype))
        if stop_gradient:
            if data.requires_grad:
                data = data.detach()
        elif not data.requires_grad and _grad_dtype(data):
            data = data.detach().requires_grad_(True)
        self._init(data, name)

    def _init(self, data, name=None):
        self._data = data
        self._name = name
        self.persistable = False
        self.trainable = True
        self.is_distributed = False
        self._dist_attr = None
        self.main_grad = None

    @classmethod
    def _wrap(cls, data, name=None):
        """A handle over the torch tensor ``data`` as it is (its graph
        and requires_grad kept), 64-bit types narrowed."""
        obj = cls.__new__(cls)
        target = canonical(data.dtype)
        obj._init(data if target == data.dtype else data.to(target), name)
        return obj

    # -- core properties ---------------------------------------------------
    @property
    def name(self):
        if self._name is None:
            self._name = f"generated_tensor_{next(_names)}"
        return self._name

    @name.setter
    def name(self, value):
        self._name = value

    @property
    def data(self):
        return self._data

    @data.setter
    def data(self, value):
        self._data = value._data if isinstance(value, Tensor) else value

    @property
    def shape(self):
        return list(self._data.shape)

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def ndim(self):
        return self._data.ndim

    def dim(self):
        return self._data.ndim

    @property
    def size(self):
        return self._data.numel()

    @property
    def T(self):
        from .. import ops
        return ops.transpose(self, list(range(self.ndim))[::-1])

    @property
    def place(self):
        return place_of(self._data.device)

    @property
    def stop_gradient(self):
        return not self._data.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        t = self._data
        if value:
            if t.grad_fn is not None:
                self._data = t.detach()
            elif t.requires_grad:
                t.requires_grad_(False)
        elif not t.requires_grad and _grad_dtype(t):
            t.requires_grad_(True)

    @property
    def grad(self):
        g = self._data.grad
        return None if g is None else Tensor._wrap(g)

    @grad.setter
    def grad(self, value):
        if value is None:
            self._data.grad = None
            return
        g = value._data if isinstance(value, Tensor) else \
            torch.as_tensor(np.asarray(value))
        self._data.grad = g.to(self._data.device, self._data.dtype)

    @property
    def is_leaf(self):
        return autograd.is_leaf(self)

    # -- autograd ----------------------------------------------------------
    def backward(self, grad_tensor=None, retain_graph=False):
        autograd.backward(self, grad_tensor, retain_graph)

    def clear_grad(self):
        self._data.grad = None

    clear_gradient = clear_grad

    def retain_grads(self):
        if self._data.requires_grad:
            self._data.retain_grad()

    def register_hook(self, hook):
        """``hook(grad)`` on this tensor's gradient (a Tensor); a Tensor
        it returns replaces the gradient."""
        def torch_hook(g):
            out = hook(Tensor._wrap(g))
            return out._data if isinstance(out, Tensor) else out
        return self._data.register_hook(torch_hook)

    # -- conversion --------------------------------------------------------
    def numpy(self):
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().resolve_conj().numpy()

    def item(self, *args):
        if args:
            return self.numpy().item(*args)
        return self._data.item()

    def tolist(self):
        return self.numpy().tolist()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def astype(self, dtype):
        from .. import ops
        return ops.cast(self, dtype)

    def cast(self, dtype):
        return self.astype(dtype)

    def detach(self):
        return Tensor._wrap(self._data.detach(), name=self.name + ".detach")

    def detach_(self):
        self.stop_gradient = True
        return self

    def clone(self):
        from .op import apply
        return apply(torch.clone, (self,))

    def numel(self):
        return self.size

    def element_size(self):
        return self._data.element_size()

    # -- mutation ----------------------------------------------------------
    def set_value(self, value):
        """Write ``value`` into this tensor (in place under no_grad when
        the shape is this tensor's; a new shape rebinds ``_data``)."""
        v = value._data if isinstance(value, Tensor) else \
            torch.as_tensor(np.asarray(value))
        v = v.to(self._data.device, self._data.dtype)
        if tuple(v.shape) == tuple(self._data.shape):
            with torch.no_grad():
                self._data.copy_(v)
        else:
            self._data = v.detach().clone().requires_grad_(
                self._data.requires_grad)
        return self

    def copy_(self, other, blocking=True):
        return self.set_value(other)

    def fill_(self, value):
        with torch.no_grad():
            self._data.fill_(value)
        return self

    def zero_(self):
        with torch.no_grad():
            self._data.zero_()
        return self

    # -- placement -----------------------------------------------------------
    def _moved(self, device):
        from .op import apply
        return apply(lambda t: t.to(device), (self,))

    def cuda(self, device_id=None, blocking=True):
        return self._moved(resolve_device(
            "cuda" if device_id is None else f"cuda:{int(device_id)}"))

    def cpu(self):
        return self._moved(torch.device("cpu"))

    def pin_memory(self):
        return Tensor._wrap(self._data.pin_memory())

    def to(self, *args, **kwargs):
        """``to(device)``, ``to(dtype)`` or both; ``blocking`` is
        accepted."""
        out = self
        for a in list(args) + [v for k, v in kwargs.items()
                               if k != "blocking"]:
            if isinstance(a, builtins.bool) or a is None:
                continue
            if isinstance(a, str) and a.split(":")[0] in ("cpu", "gpu",
                                                          "cuda"):
                a = parse_place(a)
            if isinstance(a, Place):
                out = out._moved(a.torch_device())
            elif isinstance(a, torch.device):
                out = out._moved(resolve_device(a))
            else:
                out = out.astype(a)
        return out

    def value(self):
        return self

    def get_tensor(self):
        return self

    # -- indexing ----------------------------------------------------------
    def _index(self, idx):
        """``idx`` with handles, numpy arrays and lists of numbers as
        torch index tensors on this tensor's device."""
        dev = self._data.device
        if isinstance(idx, Tensor):
            idx = idx._data
        if isinstance(idx, torch.Tensor):
            return idx.to(dev, torch.long) if not (
                idx.dtype == torch.bool or idx.is_floating_point()) \
                else idx.to(dev)
        if isinstance(idx, tuple):
            idx = tuple(self._index(i) for i in idx)
            if any(isinstance(i, torch.Tensor) and i.ndim for i in idx):
                # numpy (and the reference) count an int beside an array
                # index as an advanced index, which moves the broadcast
                # dims first when a slice parts them; torch takes the int
                # as a basic index unless it is an index tensor too
                idx = tuple(torch.tensor([i], device=dev)
                            if isinstance(i, int) and not isinstance(
                                i, builtins.bool) else i for i in idx)
            return idx
        if isinstance(idx, np.ndarray):
            return self._index(torch.from_numpy(idx))
        if isinstance(idx, list) and idx and not builtins.any(
                i is None or i is Ellipsis or isinstance(i, slice)
                for i in idx):
            return self._index(torch.as_tensor(np.asarray(
                [i._data.item() if isinstance(i, Tensor) else i
                 for i in idx])))
        if isinstance(idx, np.integer):
            return int(idx)
        return idx

    def __getitem__(self, idx):
        from .op import apply
        idx = self._index(idx)
        return apply(lambda x: x[idx], (self,))

    def __setitem__(self, idx, value):
        from .op import check_inplace
        check_inplace(self)
        idx = self._index(idx)
        v = value._data if isinstance(value, Tensor) else value
        if isinstance(v, torch.Tensor):
            v = v.to(self._data.device, self._data.dtype)
        elif isinstance(v, (np.ndarray, list, tuple)):
            v = torch.as_tensor(np.asarray(v)).to(self._data.device,
                                                  self._data.dtype)
        self._data[idx] = v

    # -- python protocol ---------------------------------------------------
    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-d tensor")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __bool__(self):
        return bool(self._data.detach())

    def __int__(self):
        return int(self._data.detach())

    def __float__(self):
        return float(self._data.detach())

    def __index__(self):
        return int(self._data.detach())

    def __hash__(self):
        return id(self)

    def __repr__(self):
        return (f"Tensor(shape={self.shape}, dtype={dtype_name(self.dtype)}, "
                f"place={self.place}, stop_gradient={self.stop_gradient},\n"
                f"{self.numpy()!r})")

    def __format__(self, spec):
        if self.ndim == 0:
            return format(self.item(), spec)
        return format(str(self), spec)

    # arithmetic dunders are installed by ops.install_tensor_methods()


class Parameter(Tensor):
    """A trainable Tensor (the reference's ``Parameter(Tensor)``):
    ``stop_gradient`` False unless not trainable, ``persistable`` True.
    The port's ``nn.Layer``s hold ``torch.nn.Parameter``s instead."""
    __slots__ = ("optimize_attr", "regularizer", "do_model_average",
                 "need_clip", "is_dist_param")

    def __init__(self, data, dtype=None, name=None, trainable=True):
        super().__init__(data, dtype=dtype, stop_gradient=not trainable,
                         name=name)
        self.persistable = True
        self.trainable = trainable
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.do_model_average = None
        self.need_clip = True
        self.is_dist_param = False

    def initialize(self):
        """``LazyGuard`` counterpart: parameters are made at construction,
        so there is nothing left to initialize."""
        return self


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """``paddle.to_tensor``: a Tensor of ``data`` on ``place`` (the
    current device when None; see ``framework/device.py``)."""
    if isinstance(place, str):
        place = parse_place(place)
    if isinstance(data, Tensor):
        data = data._data.detach()
    return Tensor(data, dtype=dtype, stop_gradient=stop_gradient,
                  place=place)
