"""Activation recompute (counterpart of
paddle_tpu/distributed/fleet/recompute.py), over
`torch.utils.checkpoint` (use_reentrant=False).

`True` (or None) is the reference's keep-nothing policy: the backward
recomputes the whole function. The reference's named jax policies
(`dots_saveable`, ...) keep chosen intermediates; they are not ported.
Dropout inside a recomputed block draws the same mask in the recompute
as in the forward: the generator installed by `core.rng.generator_scope`
is replayed from its state at the start of the block.
"""
import contextlib

import torch
from torch.utils.checkpoint import checkpoint

from ...core import rng

__all__ = ["recompute", "checkpoint_policy", "rng_replay_contexts"]

_JAX_POLICIES = ("everything_saveable", "nothing_saveable", "dots_saveable",
                 "dots_with_no_batch_dims_saveable")


def checkpoint_policy(name):
    """None / True / False → None (keep nothing); a named jax policy
    raises NotImplementedError; anything else ValueError."""
    if name is None or isinstance(name, bool):
        return None
    if name in _JAX_POLICIES:
        raise NotImplementedError(
            f"recompute policy {name!r} is not ported yet (ROADMAP A8: "
            "remat policies); True keeps nothing")
    raise ValueError(f"unknown checkpoint policy {name!r}")


def rng_replay_contexts():
    """(forward context, recompute context) for torch's checkpoint: the
    recompute runs under a copy of the scoped generator as it stood
    before the forward."""
    gen = rng.current_generator()
    if gen is None:
        return contextlib.nullcontext(), contextlib.nullcontext()
    replay = torch.Generator(device=gen.device)
    replay.set_state(gen.get_state())
    return contextlib.nullcontext(), rng.generator_scope(replay)


def recompute(function, *args, policy=None, preserve_rng_state=True,
              **kwargs):
    """`function(*args, **kwargs)` with its activations recomputed in
    backward instead of kept."""
    checkpoint_policy(policy)
    kwargs.pop("use_reentrant", None)
    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state,
                      context_fn=rng_replay_contexts, **kwargs)
