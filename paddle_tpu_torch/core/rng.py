"""Explicit random generators (counterpart of paddle_tpu/core/rng.py).

The JAX package threads PRNG keys; the port hands out `torch.Generator`s.
`seed(n)` sets the global seed; `next_generator(device)` returns a fresh
generator seeded from (seed, call index), so a run is reproducible from
its seed. `generator_scope(gen)` installs the generator that dropout draws
from for the length of a block (TrainStep installs one per step); outside
a scope each dropout call takes a fresh `next_generator`.

The numbers differ from jax's for the same seed: tests never compare
random bits, they feed both packages the same numpy noise.
"""
import contextlib
import threading

import numpy as np
import torch

__all__ = ["seed", "next_generator", "generator_scope", "current_generator"]


class _State(threading.local):
    def __init__(self):
        self.scoped = None


_lock = threading.Lock()
_seed = int(np.random.randint(0, 2**31 - 1))
_count = 0
_state = _State()


def seed(n):
    """paddle.seed: restart the stream of `next_generator` from `n`."""
    global _seed, _count
    with _lock:
        _seed, _count = int(n), 0


def next_generator(device="cpu"):
    """A fresh generator on `device`, deterministic in (seed, call index)."""
    global _count
    with _lock:
        c = _count
        _count += 1
        s = _seed
    gen = torch.Generator(device=device)
    # numpy's SeedSequence mixes (seed, index) into one 64-bit seed
    gen.manual_seed(int(np.random.SeedSequence([s, c]).generate_state(
        1, np.uint64)[0]))
    return gen


@contextlib.contextmanager
def generator_scope(gen):
    """Dropout inside this block draws from `gen`."""
    old, _state.scoped = _state.scoped, gen
    try:
        yield gen
    finally:
        _state.scoped = old


def current_generator():
    """The generator installed by the innermost `generator_scope`, or
    None."""
    return _state.scoped
