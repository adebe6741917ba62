"""Explicit random generators (counterpart of paddle_tpu/core/rng.py).

The JAX package threads PRNG keys; the port hands out `torch.Generator`s.
`seed(n)` sets the global seed; `next_generator(device)` returns a fresh
generator seeded from (seed, call index), so a run is reproducible from
its seed. `next_key(device)` hands out jax's key for the same counter,
`fold_in(PRNGKey(seed), index)` as `core.prng` data, so a sampled
`generate` right after `seed(n)` draws the reference's tokens.
`generator_scope(gen)` installs the generator that dropout draws
from for the length of a block (TrainStep installs one per step); outside
a scope each dropout call takes a fresh `next_generator`. Weight
initializers draw from the scoped generator too (a model builds its
layers under one seeded from its `seed`); outside a scope they take
`next_init_generator`, a stream of its own, so building a layer leaves
the indices of dropout's and sampling's draws as they were.

The reference's stateful surface sits over the same streams:
`Generator(seed)` is a stream of its own (`next_generator`,
`get_state` / `set_state`, `manual_seed`); `default_generator()` is the
global stream itself (its `manual_seed` is `seed`); an
`RNGStatesTracker` keeps named Generators, and inside its
`rng_state(name)` every `next_generator` call draws from that stream
(the model-parallel dropout streams). A state taken with `get_state`
and set back replays the same draws.

A generator's numbers differ from jax's for the same seed: tests never
compare them, they feed both packages the same numpy noise.
"""
import contextlib
import threading

import numpy as np
import torch

from . import prng

__all__ = ["seed", "next_generator", "next_init_generator", "next_key",
           "skip", "generator_scope", "current_generator", "get_state",
           "set_state", "Generator", "default_generator", "RNGStatesTracker",
           "get_rng_state_tracker"]


class _State(threading.local):
    def __init__(self):
        self.scoped = None
        self.stream = None      # a tracker's Generator inside rng_state


_lock = threading.Lock()
_seed = int(np.random.randint(0, 2**31 - 1))
_count = 0
_init_count = 0
_state = _State()


def seed(n):
    """paddle.seed: restart the streams of `next_generator` and
    `next_init_generator` from `n`."""
    global _seed, _count, _init_count
    with _lock:
        _seed, _count, _init_count = int(n), 0, 0


def _seeded(device, words):
    gen = torch.Generator(device=device)
    # numpy's SeedSequence mixes the words into one 64-bit seed
    gen.manual_seed(int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0]))
    return gen


def next_generator(device="cpu"):
    """A fresh generator on `device`, deterministic in (seed, call index)
    — of the tracker stream whose `rng_state` block is open, else of the
    global stream."""
    global _count
    if _state.stream is not None:
        return _state.stream.next_generator(device)
    with _lock:
        c = _count
        _count += 1
        s = _seed
    return _seeded(device, [s, c])


def next_init_generator(device="cpu"):
    """A fresh generator for a weight initializer outside a generator
    scope, deterministic in (seed, initializer call index) and apart
    from `next_generator`'s stream."""
    global _init_count
    with _lock:
        c = _init_count
        _init_count += 1
        s = _seed
    return _seeded(device, [s, c, 1])


def next_key(device="cpu"):
    """The reference's `core.rng.next_key()`: jax's
    `fold_in(PRNGKey(seed), index)` for the next call index of the same
    counter `next_generator` draws from, as an int64 [2] key of
    `core.prng` on `device`."""
    global _count
    with _lock:
        c = _count
        _count += 1
        s = _seed
    return prng.fold_in(prng.prng_key(s, device=device), c)


def skip(n=1):
    """Advance the counter by `n` call indices without drawing: where
    the reference draws a key the port has no use for (each call of a
    `to_static` program takes one), so later draws keep its indices."""
    global _count
    with _lock:
        _count += int(n)


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


def get_state():
    """The streams' state, (seed, call index, initializer call index):
    `set_state` of it replays the same generators."""
    with _lock:
        return (_seed, _count, _init_count)


def set_state(state):
    global _seed, _count, _init_count
    with _lock:
        _seed, _count, _init_count = (int(v) for v in state)


class Generator:
    """A seeded stream of its own: each `next_generator(device)` is
    deterministic in (seed, call index)."""

    def __init__(self, seed=0):
        self._seed = int(seed)
        self._count = 0
        self._lock = threading.Lock()

    def manual_seed(self, seed):
        with self._lock:
            self._seed, self._count = int(seed), 0
        return self

    def seed(self):
        return self._seed

    def _next_index(self):
        with self._lock:
            c = self._count
            self._count += 1
        return self._seed, c

    def next_generator(self, device="cpu"):
        s, c = self._next_index()
        return _seeded(device, [s, c, 2])

    def next_key(self, device="cpu"):
        """jax's fold_in(PRNGKey(seed), index) as a `core.prng` key."""
        s, c = self._next_index()
        return prng.fold_in(prng.prng_key(s, device=device), c)

    def get_state(self):
        return (self._seed, self._count)

    def set_state(self, state):
        with self._lock:
            self._seed, self._count = int(state[0]), int(state[1])


class _GlobalGenerator(Generator):
    """The global stream (`seed`, `next_generator`) as a Generator."""

    def __init__(self):
        self._lock = threading.Lock()

    def manual_seed(self, s):
        seed(s)
        return self

    def seed(self):
        return get_state()[0]

    def next_generator(self, device="cpu"):
        return next_generator(device)

    def next_key(self, device="cpu"):
        return next_key(device)

    def get_state(self):
        return get_state()

    def set_state(self, state):
        set_state(state)


class RNGStatesTracker:
    """Named streams (the reference's model-parallel RNG tracker):
    inside `rng_state(name)` every draw comes from that stream."""

    def __init__(self):
        self.states = {}

    def add(self, name, seed):
        if name in self.states:
            raise ValueError(f"rng state {name!r} already exists")
        self.states[name] = Generator(seed)

    def get(self, name):
        return self.states[name]

    def reset(self):
        self.states = {}

    @contextlib.contextmanager
    def rng_state(self, name="global"):
        old, _state.stream = _state.stream, self.states[name]
        try:
            yield
        finally:
            _state.stream = old


_default_generator = _GlobalGenerator()
_tracker = RNGStatesTracker()


def default_generator():
    return _default_generator


def get_rng_state_tracker():
    return _tracker
