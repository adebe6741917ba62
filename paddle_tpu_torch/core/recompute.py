"""Whether the running code is an activation recompute.

A checkpointed block runs its forward twice: once in the forward, and
again in backward to rebuild what it did not keep. State that the
forward updates in place (batch norm's running statistics) must change
once a step, as the reference's one traced forward changes it, so such
an update asks `in_recompute()` and is skipped there.
`distributed.fleet.recompute` enters `recompute_scope()` around every
recompute, whatever the policy.
"""
import contextlib
import threading

__all__ = ["in_recompute", "recompute_scope"]


class _State(threading.local):
    def __init__(self):
        self.depth = 0


_state = _State()


def in_recompute():
    """True inside a recompute (the backward's second run of a
    checkpointed forward)."""
    return _state.depth > 0


@contextlib.contextmanager
def recompute_scope():
    _state.depth += 1
    try:
        yield
    finally:
        _state.depth -= 1
