"""Control-flow ops: cond / while_loop / case / switch_case / scan
(counterpart of paddle_tpu/ops/control_flow.py).

The reference lowers a traced predicate to `lax.cond` / `lax.while_loop`
/ `lax.switch` and runs a concrete one in Python. The port has no
trace, so every call takes the reference's eager path: a tensor
predicate is read with `bool()` (one host read on the card), the taken
branch or the loop runs in Python, and autograd sees exactly the ops
that ran. `scan` is the eager loop `lax.scan` stands for: fn(carry, x)
→ (carry, y) over the leading dim of `xs`, the ys stacked in the order
of `xs` (also with `reverse`); `params` has nothing to do here (the
closure's tensors are differentiated by torch's autograd as they are
used).
"""
import torch

from ._helpers import defop

__all__ = ["cond", "while_loop", "case", "switch_case", "scan"]


def _true(pred):
    return bool(pred.item() if isinstance(pred, torch.Tensor) else pred)


@defop("cond")
def cond(pred, true_fn=None, false_fn=None, name=None):
    """true_fn() or false_fn() by `pred`."""
    if _true(pred):
        return true_fn() if true_fn is not None else None
    return false_fn() if false_fn is not None else None


@defop("while_loop")
def while_loop(cond_fn, body_fn, loop_vars, is_test=False, name=None):
    """while cond_fn(*vars): vars = body_fn(*vars); returns the list of
    final vars."""
    vars_ = list(loop_vars)
    while _true(cond_fn(*vars_)):
        out = body_fn(*vars_)
        vars_ = list(out) if isinstance(out, (tuple, list)) else [out]
    return vars_


@defop("case")
def case(pred_fn_pairs, default=None, name=None):
    """The fn of the first pair whose predicate holds; with no default
    the last pair's fn is the fallback (the reference's rule)."""
    pairs = list(pred_fn_pairs)
    if default is None:
        default = pairs[-1][1]
        pairs = pairs[:-1]
    for pred, fn in pairs:
        if _true(pred):
            return fn()
    return default()


@defop("switch_case")
def switch_case(branch_index, branch_fns, default=None, name=None):
    """The branch of `branch_index` (a dict {index: fn}, a list of
    (index, fn) or of fns); an unmatched index takes `default`, else the
    last branch."""
    if isinstance(branch_fns, dict):
        pairs = sorted(branch_fns.items())
    elif branch_fns and isinstance(branch_fns[0], (tuple, list)):
        pairs = sorted((int(i), f) for i, f in branch_fns)
    else:
        pairs = list(enumerate(branch_fns))
    i = int(branch_index.item() if isinstance(branch_index, torch.Tensor)
            else branch_index)
    for idx, fn in pairs:
        if idx == i:
            return fn()
    return default() if default is not None else pairs[-1][1]()


def _stack(ys):
    first = ys[0]
    if first is None:
        return None
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([y[j] for y in ys])
                           for j in range(len(first)))
    return torch.stack(list(ys))


@defop("scan")
def scan(fn, init, xs=None, length=None, reverse=False, params=None,
         name=None):
    """(final carry, stacked ys) of fn(carry, x) over the leading dim of
    `xs` (or `length` steps with x None)."""
    n = int(xs.shape[0]) if xs is not None else int(length)
    order = range(n - 1, -1, -1) if reverse else range(n)
    carry, ys = init, [None] * n
    for i in order:
        carry, ys[i] = fn(carry, None if xs is None else xs[i])
    return carry, (_stack(ys) if n else None)
