"""`paddle.grad` and `paddle.autograd.backward` over torch's autograd
(counterpart of paddle_tpu/autograd/engine.py).

`grad` keeps the reference's rules: `retain_graph` defaults to
`create_graph`, a missing `grad_outputs` entry is ones, and an input
that no output reaches (or that needs no gradient) raises ValueError
unless `allow_unused`, which gives None for it.
"""
import torch

__all__ = ["grad", "backward", "is_grad_enabled"]

is_grad_enabled = torch.is_grad_enabled


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """Gradients of `outputs` with respect to `inputs`, as a list."""
    if no_grad_vars is not None:
        raise NotImplementedError("grad(no_grad_vars=...) is not supported "
                                  "(nor by the reference)")
    outputs, inputs = _as_list(outputs), _as_list(inputs)
    grad_outputs = ([None] * len(outputs) if grad_outputs is None
                    else _as_list(grad_outputs))
    if retain_graph is None:
        retain_graph = create_graph
    pairs = [(o, torch.ones_like(o) if g is None else g)
             for o, g in zip(outputs, grad_outputs) if o.requires_grad]
    wanted = [i for i, t in enumerate(inputs) if t.requires_grad]
    results = [None] * len(inputs)
    if pairs and wanted:
        got = torch.autograd.grad(
            [o for o, _ in pairs], [inputs[i] for i in wanted],
            [g for _, g in pairs], retain_graph=retain_graph,
            create_graph=create_graph, allow_unused=True)
        for i, g in zip(wanted, got):
            results[i] = g
    if not allow_unused and any(g is None for g in results):
        raise ValueError("one of the inputs receives no gradient; pass "
                         "allow_unused=True to permit this")
    return results


def backward(tensors, grad_tensors=None, retain_graph=False):
    """paddle.autograd.backward: accumulate into the leaves' `.grad`."""
    tensors = _as_list(tensors)
    if grad_tensors is not None:
        grad_tensors = _as_list(grad_tensors)
    torch.autograd.backward(tensors, grad_tensors, retain_graph=retain_graph)
