"""The ``paddle.tensor`` namespace (counterpart of
``paddle_tpu/tensor/__init__.py``): the ops of ``paddle_tpu_torch.ops``
under the reference's module layout (``paddle.tensor.math``,
``paddle.tensor.creation``, ...)."""
from ..ops import creation, linalg, logic, manipulation, math, search  # noqa: F401
from ..ops.creation import *  # noqa: F401,F403
from ..ops.linalg import *  # noqa: F401,F403
from ..ops.logic import *  # noqa: F401,F403
from ..ops.manipulation import *  # noqa: F401,F403
from ..ops.math import *  # noqa: F401,F403
from ..ops.search import *  # noqa: F401,F403

# the reference's submodule aliases
attribute = math
random = creation
stat = math
einsum = linalg
