"""Weights between the JAX package and the port.

`load_jax_state_dict(model, arrays)` takes a JAX model's `state_dict()`
exported as `{name: np.ndarray}` (tied or untied LM head alike) and
COPIES each array into the port model's parameter or named buffer of the
same name: the weight-only quantized layers' int8 / packed int4
`weight_q` and f32 `w_step` are buffers, so a reference model quantized
by `quantize_model_int8` / `int4` loads into the port model quantized the
same way, code for code. It never aliases the caller's arrays
(`torch.from_numpy` would share memory with the numpy array and a later
in-place update on either side would leak into the other).
`export_state_dict(model)` goes the other way: `{name: np.ndarray}`
copies of the port model's parameters and buffers, so the two packages'
weights can be compared after training.
"""
import numpy as np
import torch

__all__ = ["load_jax_state_dict", "export_state_dict"]


def _state(model):
    """{name: tensor} of the model's parameters and named buffers."""
    return {**dict(model.named_parameters()), **dict(model.named_buffers())}


@torch.no_grad()
def load_jax_state_dict(model, arrays):
    params = _state(model)
    missing = sorted(set(params) - set(arrays))
    unexpected = sorted(set(arrays) - set(params))
    if missing or unexpected:
        raise KeyError(f"state_dict mismatch: missing {missing}, "
                       f"unexpected {unexpected}")
    for name, p in params.items():
        a = np.asarray(arrays[name])
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {a.shape} != {tuple(p.shape)}")
        p.copy_(torch.tensor(a, dtype=p.dtype, device=p.device))
    return model


@torch.no_grad()
def export_state_dict(model):
    """{name: np.ndarray} copies of every parameter and named buffer, on
    the host; bf16 tensors come out as float32 (numpy has no bfloat16)."""
    out = {}
    for name, p in _state(model).items():
        t = p.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[name] = t.numpy().copy()
    return out
