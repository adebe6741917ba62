"""Seed control (counterpart of paddle_tpu/framework/random.py): the
global stream's state as the reference's one-element list."""
from ..core import rng

__all__ = ["seed", "get_cuda_rng_state", "set_cuda_rng_state"]


def seed(s):
    rng.seed(s)
    return rng.default_generator()


def get_cuda_rng_state():
    return [rng.default_generator().get_state()]


def set_cuda_rng_state(states):
    if states:
        rng.default_generator().set_state(states[0])
