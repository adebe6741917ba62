"""Automatic mixed precision (counterpart of paddle_tpu/amp).

The reference casts at one point, the autograd tape's `apply`, by op
name; the port's ops call `cast_inputs_for(op_name, tensors)` themselves,
under the reference's op names. The lists are the reference's own
(paddle_tpu/amp/__init__.py:24-49), copied here: under O1 white-list ops
take their float inputs down to bfloat16, black-list ops up to float32,
and every other op follows its inputs. Under O2 every op takes its float
inputs down to bfloat16 except the black-list ops, which go up to
float32; the ops of the GPT forward and `fused_head_loss` that follow
torch's type promotion (the residual and embedding adds, the head's
slice, the loss's divide) call `cast_inputs_for` under the reference's
names too, so each returns the reference's dtype. `decorate` casts a
model's floating parameters and buffers to bfloat16 in place; no f32
master copy is kept, as in the reference (the optimizers keep f32
accumulators and round each update once). `GradScaler` is the
reference's dynamic loss scaler; its finiteness check is one reduction
per gradient on the device and one read on the host per `unscale_`.

`torch.autocast` is not used: its lists differ from the reference's (it
upcasts `cross_entropy`'s whole [..., vocab] logits to f32, which the
reference deliberately avoids), so its cast points would not match.
"""
import contextlib
import threading

import torch

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler",
           "white_list", "black_list", "cast_inputs_for", "state",
           "current_policy", "policy_scope"]

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
        self.level = "O1"
        self.custom_white = set()
        self.custom_black = set()


_state = _AmpState()


def state():
    return _state


def current_policy():
    """The cast policy in force, as `policy_scope` takes it back."""
    return (_state.enabled, _state.level, set(_state.custom_white),
            set(_state.custom_black))


@contextlib.contextmanager
def policy_scope(policy):
    """Run the block under a policy `current_policy` returned: the
    recompute of a checkpointed block runs in backward, outside the
    forward's `auto_cast`, and must cast as the forward did."""
    old = current_policy()
    (_state.enabled, _state.level, _state.custom_white,
     _state.custom_black) = policy
    try:
        yield
    finally:
        (_state.enabled, _state.level, _state.custom_white,
         _state.custom_black) = old


def white_list():
    return (WHITE_LIST | _state.custom_white) - _state.custom_black


def black_list():
    return (BLACK_LIST | _state.custom_black) - _state.custom_white


def cast_inputs_for(op_name, tensors):
    """The inputs of op `op_name` under the current policy, as a tuple:
    float tensors cast down (O1: white list; O2: every op not on the
    black list) or up (black list); everything else (int tensors, None)
    passes through."""
    tensors = tuple(tensors)
    if not _state.enabled:
        return tensors
    if op_name in black_list():
        to = torch.float32
    elif _state.level == "O2" or op_name in white_list():
        to = torch.bfloat16
    else:
        return tensors
    return tuple(t.to(to) if isinstance(t, torch.Tensor)
                 and t.is_floating_point() else t for t in tensors)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """Mixed precision in bfloat16 for the ops run inside the block, at
    level O1 or O2."""
    if level not in ("O1", "O2"):
        raise ValueError(f"unknown AMP level {level!r}")
    _check_dtype(dtype)
    old = (_state.enabled, _state.level, _state.custom_white,
           _state.custom_black)
    _state.enabled = bool(enable)
    _state.level = level
    _state.custom_white = set(custom_white_list or ())
    _state.custom_black = set(custom_black_list or ())
    try:
        yield
    finally:
        (_state.enabled, _state.level, _state.custom_white,
         _state.custom_black) = old


amp_guard = auto_cast


def _check_dtype(dtype):
    if str(dtype) not in ("bfloat16", "bf16", "torch.bfloat16"):
        raise ValueError(f"AMP dtype {dtype!r}: the port runs bfloat16")


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2 decoration: every floating parameter and buffer of each model
    cast to bfloat16 in place (the same Parameter objects, so optimizers
    built before keep them). `level`, `master_weight` and `save_dtype`
    are taken and ignored, as in the reference. Returns `models`, or
    `(models, optimizers)` when optimizers are given."""
    _check_dtype(dtype)
    for m in (models if isinstance(models, (list, tuple)) else [models]):
        m.to(torch.bfloat16)
    if optimizers is None:
        return models
    return models, optimizers


class GradScaler:
    """Dynamic loss scaling (reference: paddle_tpu/amp/__init__.py:136-244).

    `unscale_(opt)` divides the gradients of `opt`'s parameters by the
    scale (in f32, cast back to each gradient's dtype) and notes whether
    any is non-finite, once per optimizer per `update()`; `step(opt)`
    unscales if needed and skips `opt.step()` on overflow; `update()`
    halves the scale after `decr_every_n_nan_or_inf` bad steps in a row
    (not below 1) and doubles it after `incr_every_n_steps` good ones."""

    def __init__(self, enable=True, init_loss_scaling=2.0**15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        # per optimizer since the last update(): unscale_ -> clip -> step
        # must not divide twice, and one optimizer's overflow must not
        # skip another's step
        self._unscaled = set()
        self._found_inf_per_opt = {}

    def is_enable(self):
        return self._enable

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        if not self._enable:
            return
        if id(optimizer) in self._unscaled:
            raise RuntimeError(
                "unscale_() has already been called on this optimizer "
                "since the last update().")
        inv = 1.0 / self._scale
        finite = []
        for p in optimizer._parameter_list:
            if p.grad is None:
                continue
            g = p.grad.float() * inv
            finite.append(torch.isfinite(g).all())
            p.grad.copy_(g)
        # one device reduction over the per-gradient flags, one host read
        found = bool(finite) and not bool(torch.stack(finite).all())
        self._found_inf = self._found_inf or found
        self._found_inf_per_opt[id(optimizer)] = found
        self._unscaled.add(id(optimizer))

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if id(optimizer) not in self._unscaled:
            self.unscale_(optimizer)
        if not self._found_inf_per_opt.get(id(optimizer), False):
            optimizer.step()

    def update(self):
        self._unscaled.clear()
        self._found_inf_per_opt.clear()
        found_inf, self._found_inf = self._found_inf, False
        if not (self._enable and self._dynamic):
            return
        if found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def minimize(self, optimizer, scaled):
        scaled.backward()
        self.step(optimizer)
        self.update()

    def get_loss_scaling(self):
        """The scale as a 0-d float32 tensor."""
        return torch.tensor(self._scale, dtype=torch.float32)

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {
            "scale": self._scale,
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every,
            "decr_every_n_nan_or_inf": self._decr_every,
            "good_steps": self._good_steps,
            "bad_steps": self._bad_steps,
        }

    def load_state_dict(self, d):
        self._scale = d.get("scale", self._scale)
        self._good_steps = d.get("good_steps", 0)
        self._bad_steps = d.get("bad_steps", 0)
