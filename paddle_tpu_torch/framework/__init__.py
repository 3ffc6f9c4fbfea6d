"""Framework core of the port (counterpart of
``paddle_tpu/framework/__init__.py``): ``Tensor`` over torch tensors
(``tensor``), autograd over torch's (``autograd``), dtypes, places and
the default device, random seeds, the op boundary (``op``), the
reference parameters accepted without an implementation (``unported``)
and ``paddle.save`` / ``paddle.load`` (``io``)."""
from . import autograd, device, dtype, random  # noqa: F401
from .autograd import no_grad, enable_grad, set_grad_enabled, grad  # noqa: F401
from .device import (CPUPlace, CUDAPinnedPlace, CUDAPlace, CustomPlace,  # noqa: F401
                     Place, TPUPlace, XPUPlace, device_count, get_device,
                     is_compiled_with_cuda, is_compiled_with_tpu,
                     is_compiled_with_xpu, set_device)
from .dtype import (convert_dtype, get_default_dtype,  # noqa: F401
                    set_default_dtype)
from .random import seed, get_rng_state, set_rng_state  # noqa: F401
from .tensor import Parameter, Tensor, to_tensor  # noqa: F401
