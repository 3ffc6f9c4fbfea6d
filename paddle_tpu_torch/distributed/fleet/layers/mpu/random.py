"""The RNG state tracker of hybrid parallelism (counterpart of
paddle_tpu/distributed/fleet/layers/mpu/random.py:1-73).

A tracker holds named CPU ``torch.Generator``s. Inside ``rng_state(name)``
torch's default CPU generator runs on that stream, so every draw that
takes no generator (the dropout seeds of ``framework/random.draw_seed``,
the initializers' default) comes from it; on exit the stream keeps its
new state and the default generator gets its own back.
``model_parallel_random_seed`` seeds the ``model_parallel_rng`` stream
with ``seed + 1024 + mp_rank`` and the global generator with ``seed``.
"""
from __future__ import annotations

import contextlib
import random as _pyrandom

import torch

from .....framework import random as _random

__all__ = ["MODEL_PARALLEL_RNG", "RNGStatesTracker", "determinate_seed",
           "get_rng_state_tracker", "model_parallel_random_seed"]

MODEL_PARALLEL_RNG = "model_parallel_rng"


class RNGStatesTracker:
    def __init__(self):
        self.states_ = {}
        self.seeds_ = set()

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()

    def add(self, name, seed):
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already exists")
        self.seeds_.add(seed)
        if name in self.states_:
            raise ValueError(f"state {name} already exists")
        self.states_[name] = torch.Generator().manual_seed(int(seed))

    def get_states_tracker(self):
        """{name: generator state} (a copy)."""
        return {k: g.get_state() for k, g in self.states_.items()}

    def set_states_tracker(self, states):
        self.states_ = {}
        for k, st in states.items():
            g = torch.Generator()
            g.set_state(st)
            self.states_[k] = g

    @contextlib.contextmanager
    def rng_state(self, name=MODEL_PARALLEL_RNG):
        if name not in self.states_:
            raise ValueError(f"state {name} does not exist")
        default = torch.default_generator
        orig = default.get_state()
        default.set_state(self.states_[name].get_state())
        try:
            yield
        finally:
            self.states_[name].set_state(default.get_state())
            default.set_state(orig)


_RNG_STATE_TRACKER = RNGStatesTracker()


def get_rng_state_tracker():
    return _RNG_STATE_TRACKER


def model_parallel_random_seed(seed=None):
    """Seed the tracker's model-parallel stream (``seed + 1024 +
    mp_rank``) and the global generator (``seed``); a random seed when
    None, as the reference draws one."""
    from ...topology import get_hybrid_communicate_group
    seed = seed if seed is not None else _pyrandom.randint(0, 2 ** 31 - 1)
    hcg = get_hybrid_communicate_group()
    mp_rank = hcg.get_model_parallel_rank() if hcg else 0
    _RNG_STATE_TRACKER.reset()
    _RNG_STATE_TRACKER.add(MODEL_PARALLEL_RNG, seed + 1024 + mp_rank)
    _random.seed(seed)


def determinate_seed(rng_name):
    return 0
