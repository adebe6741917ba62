"""Automatic mixed precision (counterpart of paddle_tpu/amp).

The reference casts at one point, the autograd tape's `apply`, by op
name; the port's ops call `cast_inputs_for(op_name, tensors)` themselves,
under the reference's op names. The lists are the reference's own
(paddle_tpu/amp/__init__.py:24-49), copied here: under O1 white-list ops
take their float inputs down to bfloat16, black-list ops up to float32,
and every other op follows its inputs.

`torch.autocast` is not used: its lists differ from the reference's (it
upcasts `cross_entropy`'s whole [..., vocab] logits to f32, which the
reference deliberately avoids), so its cast points would not match.
"""
import contextlib
import threading

import torch

__all__ = ["auto_cast", "decorate", "white_list", "black_list",
           "cast_inputs_for", "state"]

# ops that are numerically safe and fast in low precision
WHITE_LIST = {
    "matmul", "linear", "conv1d", "conv2d", "conv3d", "conv1d_transpose",
    "conv2d_transpose", "conv3d_transpose", "bmm", "mm", "mv",
    "scaled_dot_product_attention", "flash_attention", "einsum",
    # the fused head-CE accumulates in f32 itself; its x / w inputs go
    # down like any other matmul's
    "fused_linear_cross_entropy",
}
# numerically sensitive ops forced to f32 ("cross_entropy" is deliberately
# absent: its fused core does f32 math inside)
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "softmax", "log_softmax",
    "nll_loss", "binary_cross_entropy", "bce_with_logits",
    "kl_div", "mean", "sum", "norm", "batch_norm", "batch_norm_infer",
    "layer_norm", "group_norm", "instance_norm", "softmax_with_cross_entropy",
    "sigmoid_focal_loss", "cosine_similarity", "pow", "square", "sqrt",
    "rsqrt", "cumsum", "cumprod", "var", "std", "renorm", "dist", "erfinv",
}


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.custom_white = set()
        self.custom_black = set()


_state = _AmpState()


def state():
    return _state


def white_list():
    return (WHITE_LIST | _state.custom_white) - _state.custom_black


def black_list():
    return (BLACK_LIST | _state.custom_black) - _state.custom_white


def cast_inputs_for(op_name, tensors):
    """The inputs of op `op_name` under the current policy, as a tuple:
    float tensors cast down (white list) or up (black list); everything
    else (int tensors, None) passes through."""
    tensors = tuple(tensors)
    if not _state.enabled:
        return tensors
    if op_name in white_list():
        to = torch.bfloat16
    elif op_name in black_list():
        to = torch.float32
    else:
        return tensors
    return tuple(t.to(to) if isinstance(t, torch.Tensor)
                 and t.is_floating_point() else t for t in tensors)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """O1 mixed precision in bfloat16 for the ops run inside the block."""
    if level == "O2":
        raise NotImplementedError(
            "AMP level O2 (pure low precision) is not ported yet "
            "(ROADMAP A8: O2)")
    if level != "O1":
        raise ValueError(f"unknown AMP level {level!r}")
    if str(dtype) not in ("bfloat16", "bf16", "torch.bfloat16"):
        raise ValueError(f"AMP dtype {dtype!r}: the port runs bfloat16")
    old = (_state.enabled, _state.custom_white, _state.custom_black)
    _state.enabled = bool(enable)
    _state.custom_white = set(custom_white_list or ())
    _state.custom_black = set(custom_black_list or ())
    try:
        yield
    finally:
        _state.enabled, _state.custom_white, _state.custom_black = old


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2 decoration (parameters cast to the low dtype) — not ported."""
    raise NotImplementedError(
        "amp.decorate (AMP level O2) is not ported yet (ROADMAP A8: O2)")
