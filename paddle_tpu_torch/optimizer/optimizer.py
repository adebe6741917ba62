"""Optimizers (counterpart of paddle_tpu/optimizer/optimizer.py).

Each optimizer writes out the reference's per-parameter update op for op
(`_update`), applied in place under `torch.no_grad()`; `torch.optim` is
not used, so a trajectory matches the reference step for step.
Low-precision (bf16) parameters always get f32 accumulators (as in the
reference, whatever its `multi_precision` says) and their gradient is
upcast before the moment math; the parameter keeps its own dtype.
Options no caller passes (`lazy_mode`, `multi_precision`, `name`,
`clear_grad`'s `set_to_zero`) are not taken.
"""
import torch

__all__ = ["Optimizer", "Adam", "AdamW"]


def _acc_dtype(p):
    return torch.float32 if p.dtype in (torch.bfloat16, torch.float16) \
        else p.dtype


def _acc_zeros(p):
    """Accumulator for one parameter: f32 for low-precision parameters
    ((1 - beta2)·g² underflows in bf16 and small updates round away)."""
    return torch.zeros(p.shape, dtype=_acc_dtype(p), device=p.device)


class Optimizer:
    """`parameters`: an iterable of tensors, or of (name, tensor) pairs
    such as `model.named_parameters()` (the names are what AdamW's
    `apply_decay_param_fun` sees). The learning rate is a float."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
        if parameters is None:
            raise ValueError("parameters is required (pass "
                             "model.parameters() or model.named_parameters())")
        if grad_clip is not None:
            raise NotImplementedError(
                "grad_clip is not ported yet (ROADMAP A8: grad clip)")
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "LRScheduler learning rates are not ported yet (ROADMAP "
                "A8: lr schedules); pass a float")
        self._params = []          # [(name or None, tensor)]
        for item in parameters:
            if isinstance(item, (tuple, list)):
                self._params.append((item[0], item[1]))
            else:
                self._params.append((getattr(item, "name", None), item))
        self._learning_rate = float(learning_rate)
        self._weight_decay = weight_decay
        self._states = {}          # id(param) -> accumulators
        self._step_count = 0

    def get_lr(self):
        return self._learning_rate

    def set_lr(self, value):
        self._learning_rate = float(value)

    def _init_state(self, p):
        return {}

    def _update(self, p, g, state, lr, wd):
        """Update parameter `p` in place from gradient `g` (already in the
        accumulator dtype) and `state`; `wd` is the decoupled decay."""
        raise NotImplementedError

    def _decoupled_wd(self):
        return False

    def _weight_decay_coeff(self, name, p):
        wd = self._weight_decay
        if wd is None:
            return 0.0
        return float(getattr(wd, "_coeff", wd))

    @torch.no_grad()
    def step(self):
        self._step_count += 1
        lr = self.get_lr()
        for name, p in self._params:
            if p.grad is None or not p.requires_grad:
                continue
            state = self._states.get(id(p))
            if state is None:
                state = self._states[id(p)] = self._init_state(p)
            wd = self._weight_decay_coeff(name, p)
            g = p.grad
            if wd and not self._decoupled_wd():
                g = g + wd * p
            self._update(p, g.to(_acc_dtype(p)), state, lr,
                         wd if self._decoupled_wd() else 0.0)

    def clear_grad(self):
        for _, p in self._params:
            p.grad = None


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _init_state(self, p):
        one = torch.ones([], dtype=torch.float32, device=p.device)
        return {"moment1": _acc_zeros(p), "moment2": _acc_zeros(p),
                "beta1_pow": one, "beta2_pow": one.clone()}

    def _update(self, p, g, state, lr, wd):
        # the reference's Adam._update (optimizer.py:328-345), op for op:
        # decoupled decay on the parameter BEFORE the moment step, eps
        # added to sqrt(v̂)
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        b1p = state["beta1_pow"] * b1
        b2p = state["beta2_pow"] * b2
        m = b1 * state["moment1"] + (1 - b1) * g
        v = b2 * state["moment2"] + (1 - b2) * g * g
        # the decay is taken in the accumulator dtype, as in the compiled
        # reference step, whose lr is an f32 array (a bf16 parameter is
        # rounded once, at the end)
        pv = p.to(g.dtype) * (1.0 - lr * wd) if wd else p
        mh = m / (1 - b1p)
        vh = v / (1 - b2p)
        p.copy_(pv - lr * mh / (torch.sqrt(vh) + eps))
        state.update(moment1=m, moment2=v, beta1_pow=b1p, beta2_pow=b2p)


class AdamW(Adam):
    """Decoupled weight decay. `apply_decay_param_fun(name)` gets the
    parameter's name (its state_dict key when the optimizer was given
    `model.named_parameters()`) and decides whether it decays."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None):
        if lr_ratio is not None:
            raise NotImplementedError(
                "AdamW lr_ratio is not ported yet (ROADMAP A8: lr "
                "schedules)")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decoupled_wd(self):
        return True

    def _weight_decay_coeff(self, name, p):
        if self._apply_decay_param_fun is not None:
            if name is None:
                raise ValueError(
                    "apply_decay_param_fun needs parameter names: pass "
                    "model.named_parameters()")
            if not self._apply_decay_param_fun(name):
                return 0.0
        return super()._weight_decay_coeff(name, p)
