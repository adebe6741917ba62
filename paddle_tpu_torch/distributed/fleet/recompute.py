"""Activation recompute (counterpart of
paddle_tpu/distributed/fleet/recompute.py), over
`torch.utils.checkpoint` (use_reentrant=False).

`checkpoint_policy(name)` maps the reference's jax policy names onto
torch's selective activation checkpointing (SAC,
`create_selective_checkpoint_contexts`):

* `True` / `None` / `"nothing_saveable"`: keep nothing, the backward
  recomputes the whole function;
* `"dots_saveable"`: keep the outputs of `aten.mm`, `addmm`, `bmm` and
  `baddbmm`, recompute the rest;
* `"dots_with_no_batch_dims_saveable"`: keep `mm` and `addmm` only;
* `"everything_saveable"`: keep every op, which is running the function
  without recompute (it is run so);
* a callable: a torch SAC policy function `(ctx, op, *args, **kwargs) ->
  CheckpointPolicy`, passed through as the reference passes a jax policy.

The flash attention kernels K3-K5 run through ctypes inside an
`autograd.Function`, which no SAC policy can save: they run again in the
recompute under every policy but `everything_saveable`, as the
reference's `pallas_call` is not a dot either.

The recompute runs in backward, outside the forward's context, so the
forward's context is replayed around it: dropout draws the same mask
(the generator installed by `core.rng.generator_scope` is replayed from
its state at the start of the block), and the AMP cast policy in force
at the forward is put back (`amp.policy_scope`). The SAC contexts are
entered beside that replay, not in its place.
"""
import contextlib

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ... import amp
from ...core import rng

__all__ = ["recompute", "recompute_sequential", "checkpoint_policy",
           "everything_saveable", "run_with_policy"]

_aten = torch.ops.aten


def _saving(packets):
    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op.overloadpacket in packets
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


def everything_saveable(ctx, op, *args, **kwargs):
    """Keep every op; the callers run the function without checkpoint."""
    return CheckpointPolicy.MUST_SAVE


_POLICIES = {
    "everything_saveable": everything_saveable,
    "nothing_saveable": None,
    "dots_saveable": _saving({_aten.mm, _aten.addmm, _aten.bmm,
                              _aten.baddbmm}),
    "dots_with_no_batch_dims_saveable": _saving({_aten.mm, _aten.addmm}),
}


def checkpoint_policy(name):
    """None / True / False → None (keep nothing); a policy name → its SAC
    policy function (`everything_saveable` for that name); a callable
    passes through; anything else raises ValueError."""
    if callable(name):
        return name
    if name is None or isinstance(name, bool):
        return None
    try:
        return _POLICIES[name]
    except (KeyError, TypeError):
        raise ValueError(f"unknown checkpoint policy {name!r}; one of "
                         f"{sorted(_POLICIES)}") from None


def _rng_replay_contexts():
    """(forward context, recompute context) for torch's checkpoint: the
    recompute runs under a copy of the scoped generator as it stood
    before the forward."""
    gen = rng.current_generator()
    if gen is None:
        return contextlib.nullcontext(), contextlib.nullcontext()
    replay = torch.Generator(device=gen.device)
    replay.set_state(gen.get_state())
    return contextlib.nullcontext(), rng.generator_scope(replay)


@contextlib.contextmanager
def _entered(*contexts):
    with contextlib.ExitStack() as stack:
        for c in contexts:
            stack.enter_context(c)
        yield


def _remat_contexts(policy):
    """The `context_fn` of torch's checkpoint for SAC policy `policy`
    (None: keep nothing): the dropout and AMP replay, plus the policy's
    SAC contexts on each side."""
    def contexts():
        fwd_rng, re_rng = _rng_replay_contexts()
        re_amp = amp.policy_scope(amp.current_policy())
        if policy is None:
            return fwd_rng, _entered(re_rng, re_amp)
        fwd_sac, re_sac = create_selective_checkpoint_contexts(policy)
        return _entered(fwd_rng, fwd_sac), _entered(re_rng, re_amp, re_sac)
    return contexts


def run_with_policy(function, args, policy, preserve_rng_state=True,
                    **kwargs):
    """`function(*args, **kwargs)` recomputed in backward under SAC
    policy `policy` (None keeps nothing; `everything_saveable` runs it
    plainly)."""
    if policy is everything_saveable:
        return function(*args, **kwargs)
    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state,
                      context_fn=_remat_contexts(policy), **kwargs)


def recompute(function, *args, policy=None, preserve_rng_state=True,
              **kwargs):
    """`function(*args, **kwargs)` with its activations recomputed in
    backward instead of kept; `policy` is anything `checkpoint_policy`
    takes."""
    kwargs.pop("use_reentrant", None)
    return run_with_policy(function, args, checkpoint_policy(policy),
                           preserve_rng_state=preserve_rng_state, **kwargs)


def recompute_sequential(ctx, functions, *args):
    """Chunked recompute over a sequence of layers (reference
    recompute_sequential): `ctx["segments"]` chunks of len // segments
    layers, each recomputed as one block."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    layers = list(functions)
    chunk = max(1, len(layers) // segments)
    out = args[0] if len(args) == 1 else args
    for i in range(0, len(layers), chunk):
        def run(x, seg=layers[i:i + chunk]):
            for layer in seg:
                x = layer(x)
            return x

        out = recompute(run, out)
    return out
