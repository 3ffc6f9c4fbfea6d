"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA
Hopper. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; the hand-written kernels live in ``ops/hopper`` and
``csrc``. The JAX package ``paddle_tpu`` is the reference it is tested
against; this package never imports it.

Paddle's dygraph surface sits at the top level as in the reference
(``paddle_tpu/__init__.py:14-37``, ``:121-127``): the dtypes,
``Tensor`` / ``to_tensor``, the places and ``set_device`` (``gpu:0``
until the caller asks for ``cpu``), ``seed``, ``no_grad`` / ``grad``
and every op of ``ops`` (installed as Tensor methods and dunders). The
port's ``nn`` layers and functionals, models and optimizers work on
``torch.Tensor``s; called with Tensor handles they return handles."""
from __future__ import annotations

__version__ = "0.1.0"

from .framework import (  # noqa: F401
    CPUPlace, CUDAPinnedPlace, CUDAPlace, CustomPlace, Parameter, Place,
    TPUPlace, Tensor, XPUPlace, device_count, enable_grad, get_default_dtype,
    get_device, grad, is_compiled_with_cuda, is_compiled_with_tpu, no_grad,
    seed, set_default_dtype, set_device, set_grad_enabled, to_tensor,
)
from .framework.dtype import (  # noqa: F401
    bfloat16, bool_, complex64, complex128, float16, float32, float64, int8,
    int16, int32, int64, uint8,
)
from .framework.random import get_rng_state, set_rng_state  # noqa: F401
from .framework.api_extras import (  # noqa: F401
    LazyGuard, check_shape, dtype, finfo, get_cuda_rng_state, iinfo,
    set_cuda_rng_state, set_printoptions,
)

# the dtype alias Paddle exposes at the top level
bool = bool_  # noqa: A001

# ops: install the Tensor methods, then every op at the top level
from . import ops  # noqa: E402
ops.install_tensor_methods()
from .ops import *  # noqa: F401,F403,E402
from .ops import rank, shape, is_floating_point, is_complex  # noqa: F401,E402

from . import (amp, distributed, flags, framework, incubate,  # noqa: F401,E402
               inference, models, nn, optimizer, quantization)
from . import tensor  # noqa: F401,E402
from . import _C_ops  # noqa: F401,E402
from .device import resolve_device  # noqa: F401,E402
from .flags import get_flag, set_flags  # noqa: F401,E402
from .framework.io import load, save  # noqa: F401,E402


def in_dynamic_mode():
    """Always True: the static graph (``enable_static``) is not ported
    yet (ROADMAP Queue A item 12.5)."""
    return True


in_dygraph_mode = in_dynamic_mode


def is_grad_enabled():
    return framework.autograd.tape_enabled()
