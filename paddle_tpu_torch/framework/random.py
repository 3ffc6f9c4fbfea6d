"""Random seeds for the port's dropout sites (counterpart of
``paddle_tpu/framework/random.py``).

The JAX package splits a global key for every draw (``next_key``). The
port holds no global state: a model owns a host ``torch.Generator`` and
hands it to every dropout site, which draws an int32 seed from it on the
host (``draw_seed``: JAX's ``randint(k, (), 0, 2**31 - 1)``, no device
sync). The fused dropout kernel hashes that seed with the element index;
the plain Bernoulli forms seed a generator of the tensor's device with
it (``bernoulli_keep``). The same generator state thus gives the same
masks run after run.
"""
from __future__ import annotations

import torch


def draw_seed(generator=None) -> int:
    """An int in [0, 2**31 - 1) from a CPU generator (torch's default
    CPU generator when None)."""
    g = torch.default_generator if generator is None else generator
    if g.device.type != "cpu":
        raise ValueError("dropout seeds come from a CPU torch.Generator, "
                         f"got one on {g.device}")
    return int(torch.randint(0, 2 ** 31 - 1, (), generator=g))


def bernoulli_keep(shape, keep_prob, device, generator=None):
    """bool tensor of ``shape`` on ``device``, True with probability
    ``keep_prob``, drawn by a generator of that device seeded from
    ``draw_seed(generator)``."""
    g = torch.Generator(device=device).manual_seed(draw_seed(generator))
    return torch.rand(shape, generator=g, device=device) < keep_prob


def seed(value: int) -> None:
    """Seed torch's default generators (``paddle.seed``): the draws
    that take no generator (``draw_seed(None)``, the initializers'
    default) start again from ``value``."""
    torch.manual_seed(int(value))
