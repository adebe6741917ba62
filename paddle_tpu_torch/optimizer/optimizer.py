"""Optimizers (counterpart of paddle_tpu/optimizer/optimizer.py).

Each optimizer writes out the reference's per-parameter update op for op
(`_update`), applied in place under `torch.no_grad()`; `torch.optim` is
not used, so a trajectory matches the reference step for step.
Low-precision (bf16) parameters always get f32 accumulators (as in the
reference, whatever its `multi_precision` says): the gradient is upcast
before the moment math, the update is computed in f32 and rounded once
to the parameter's dtype, as the reference's compiled step
(`apply_gradients_tree`, which `TrainStep` runs) does.

The base class carries what the reference's does: param groups (dicts
with `params` and optional `learning_rate` / `weight_decay`), an
`LRScheduler` learning rate, `grad_clip` applied to each group's
(param, grad) pairs before the update (in `TrainStep`, to all pairs
at once, as the reference's compiled step does), a per-parameter
`optimize_attr["learning_rate"]` scale and `regularizer` (read through
`getattr`; any `_coeff` folds in as coupled L2, L1Decay included, as in
the reference), `minimize`, and `state_dict` / `set_state_dict` keyed
`f"{name}_{acc}"`, `"@step"` and `"LR_Scheduler"`. A parameter's name
is the one the optimizer was given with it (`model.named_parameters()`),
else `param_{i}` by position; repeated names get `.dedup{n}`.
Options no caller passes (`lazy_mode`, `multi_precision`, `name`,
`clear_grad`'s `set_to_zero`) are not taken.
"""
import numbers

import numpy as np
import torch

from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "LarsMomentum"]


def _acc_dtype(p):
    return torch.float32 if p.dtype in (torch.bfloat16, torch.float16) \
        else p.dtype


def _acc_zeros(p):
    """Accumulator for one parameter: f32 for low-precision parameters
    ((1 - beta2)·g² underflows in bf16 and small updates round away)."""
    return torch.zeros(p.shape, dtype=_acc_dtype(p), device=p.device)


def _ones(p):
    return torch.ones([], dtype=torch.float32, device=p.device)


def _weak(c, t):
    """Python number `c` as jnp takes it into an op with tensor `t`: a
    weakly typed scalar, rounded to a low-precision `t`'s dtype first."""
    if t.dtype in (torch.bfloat16, torch.float16):
        return float(torch.tensor(c, dtype=t.dtype))
    return c


def _norm(x):
    """L2 norm of all elements in f32 (jnp.linalg.norm of an f32 view)."""
    x = x.float()
    return torch.sqrt((x * x).sum())


class _Named:
    """A parameter as a name-based exclusion sees it: `.name` is the
    optimizer's key for it (a torch tensor's own `name` is read-only);
    everything else is the tensor's."""

    def __init__(self, name, p):
        self.name = name
        self._p = p

    def __getattr__(self, attr):
        return getattr(self._p, attr)


class Optimizer:
    """`parameters`: an iterable of tensors, of (name, tensor) pairs such
    as `model.named_parameters()`, or of param-group dicts whose
    `params` are either. The learning rate is a float or an
    `LRScheduler`."""

    # the update of each element reads only that element's gradient and
    # state (a ZeRO rank may update its block alone); False where the
    # update reads norms over the whole parameter
    _elementwise = True

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
        if parameters is None:
            raise ValueError("parameters is required (pass "
                             "model.parameters() or model.named_parameters())")
        if not isinstance(learning_rate, (numbers.Real, LRScheduler)):
            raise TypeError("learning_rate must be a float or an "
                            f"LRScheduler, not {type(learning_rate)}")
        items = list(parameters)
        groups = ([dict(g) for g in items]
                  if items and isinstance(items[0], dict)
                  else [{"params": items}])
        self._names = {}           # id(param) -> state_dict name
        seen = set()
        i = 0
        for group in groups:
            params = []
            for item in group["params"]:
                if isinstance(item, (tuple, list)):
                    name, p = item
                else:
                    name, p = getattr(item, "name", None), item
                if name is None:
                    name = f"param_{i}"
                if name in seen:
                    n = 1
                    while f"{name}.dedup{n}" in seen:
                        n += 1
                    name = f"{name}.dedup{n}"
                seen.add(name)
                self._names[id(p)] = name
                params.append(p)
                i += 1
            group["params"] = params
        self._param_groups = groups
        self._learning_rate = (learning_rate
                               if isinstance(learning_rate, LRScheduler)
                               else float(learning_rate))
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._states = {}          # id(param) -> accumulators
        self._step_count = 0

    @property
    def _parameter_list(self):
        return [p for g in self._param_groups for p in g["params"]]

    @property
    def _params(self):
        """[(name, param)] in order."""
        return [(self._names[id(p)], p) for p in self._parameter_list]

    # ---- lr ----
    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError(
                "cannot set_lr when learning rate is an LRScheduler")
        self._learning_rate = float(value)

    # ---- the update protocol ----
    def _init_state(self, p):
        return {}

    def _update(self, p, g, state, lr, wd, name):
        """Update parameter `p` in place from gradient `g` (already in the
        accumulator dtype) and `state`; `wd` is the decoupled decay,
        `name` the parameter's key."""
        raise NotImplementedError

    def _decoupled_wd(self):
        return False

    def _state_for(self, p, like=None):
        """`p`'s accumulators, made on first use in the shape of `like`
        (a ZeRO rank's slice of `p`) or of `p`."""
        state = self._states.get(id(p))
        if state is None:
            state = self._states[id(p)] = self._init_state(
                p if like is None else like)
        return state

    def _weight_decay_coeff(self, name, p, group):
        # a per-parameter regularizer takes precedence over the group's
        # and the optimizer's weight decay
        reg = getattr(p, "regularizer", None)
        if reg is not None and hasattr(reg, "_coeff"):
            return float(reg._coeff)
        wd = group.get("weight_decay", self._weight_decay)
        if wd is None:
            return 0.0
        return float(getattr(wd, "_coeff", wd))

    def _group_lr(self, group):
        lr = group.get("learning_rate")
        return self.get_lr() if lr is None else (
            float(lr()) if callable(lr) else float(lr))

    def _apply(self, group, lr, pairs, targets=None):
        """`targets` maps id(p) → the tensor the update writes and the
        gradient's matching slice (a ZeRO rank's block of `p`): the
        update runs on that block, its accumulators shaped like it."""
        for p, g in pairs:
            if g is None:
                continue
            t = p
            if targets is not None and id(p) in targets:
                t, dim, start, length = targets[id(p)]
                g = g.narrow(dim, start, length)
            name = self._names[id(p)]
            attr = getattr(p, "optimize_attr", None) or {}
            plr = lr * attr.get("learning_rate", 1.0)
            wd = self._weight_decay_coeff(name, p, group)
            if wd and not self._decoupled_wd():
                g = g + _weak(wd, t) * t
            self._update(t, g.to(_acc_dtype(t)), self._state_for(p, t),
                         plr, wd if self._decoupled_wd() else 0.0, name)

    @torch.no_grad()
    def step(self):
        with torch.profiler.record_function("optimizer.step"):
            self._step_count += 1
            for group in self._param_groups:
                pairs = [(p, p.grad) for p in group["params"]
                         if p.grad is not None and p.requires_grad]
                if self._grad_clip is not None:
                    pairs = self._grad_clip(pairs)
                self._apply(group, self._group_lr(group), pairs)

    @torch.no_grad()
    def _train_step_update(self, params, targets=None):
        """The update the reference's compiled `TrainStep` applies
        (`apply_gradients_tree`): `grad_clip` over the gradients of all
        of `params` at once, in their order, where `step()` clips group
        by group; a callable group learning rate is refused, as the
        compiled step would freeze it. Parameters this optimizer was not
        given are left alone. `targets`: as in `_apply` (the clip sees
        the whole gradients)."""
        with torch.profiler.record_function("optimizer.step"):
            group_of = {}
            for group in self._param_groups:
                if callable(group.get("learning_rate")):
                    raise NotImplementedError(
                        "per-group callable learning_rate is not supported "
                        "in TrainStep; use a single LRScheduler as the "
                        "optimizer learning_rate")
                for p in group["params"]:
                    group_of[id(p)] = group
            pairs = [(p, p.grad) for p in params
                     if id(p) in group_of and p.grad is not None]
            if self._grad_clip is not None:
                pairs = self._grad_clip(pairs)
            self._step_count += 1
            lrs = {id(g): self._group_lr(g) for g in self._param_groups}
            for p, g in pairs:
                group = group_of[id(p)]
                self._apply(group, lrs[id(group)], [(p, g)], targets)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return [], []

    def clear_grad(self):
        for p in self._parameter_list:
            p.grad = None

    clear_gradients = clear_grad

    # ---- checkpointing ----
    def state_dict(self):
        out = {}
        for p in self._parameter_list:
            state = self._states.get(id(p))
            for k, v in (state or {}).items():
                out[f"{self._names[id(p)]}_{k}"] = v
        out["@step"] = self._step_count
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        return out

    @torch.no_grad()
    def set_state_dict(self, state_dict):
        """Load accumulators (tensors or numpy arrays, copied into the
        accumulator's dtype and device), the step count and the
        scheduler's state."""
        if "@step" in state_dict:
            self._step_count = int(state_dict["@step"])
        if "LR_Scheduler" in state_dict and isinstance(
                self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        for p in self._parameter_list:
            state = self._state_for(p)
            for k, old in list(state.items()):
                v = state_dict.get(f"{self._names[id(p)]}_{k}")
                if v is None:
                    continue
                if not isinstance(v, torch.Tensor):
                    v = torch.from_numpy(np.array(v))
                state[k] = v.detach().to(device=old.device,
                                         dtype=old.dtype).clone()

    set_dict = set_state_dict


# the updates below follow paddle_tpu/optimizer/optimizer.py:281-549 op for
# op; a Python number divided by a tensor is written torch.div(tensor,
# tensor) (torch's `number / tensor` multiplies by a rounded reciprocal)

class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _update(self, p, g, state, lr, wd, name):
        p.copy_(p - lr * g)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_state(self, p):
        return {"velocity": _acc_zeros(p)}

    def _update(self, p, g, state, lr, wd, name):
        v = self._momentum * state["velocity"] + g
        if self._nesterov:
            p.copy_(p - lr * (g + self._momentum * v))
        else:
            p.copy_(p - lr * v)
        state["velocity"] = v


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _init_state(self, p):
        return {"moment1": _acc_zeros(p), "moment2": _acc_zeros(p),
                "beta1_pow": _ones(p), "beta2_pow": _ones(p)}

    def _update(self, p, g, state, lr, wd, name):
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
    parameter's name and decides whether it decays. `lr_ratio` is taken
    and ignored, as the reference ignores it."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decoupled_wd(self):
        return True

    def _weight_decay_coeff(self, name, p, group):
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(name):
            return 0.0
        return super()._weight_decay_coeff(name, p, group)


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_state(self, p):
        return {"moment": _acc_zeros(p), "inf_norm": _acc_zeros(p),
                "beta1_pow": _ones(p)}

    def _update(self, p, g, state, lr, wd, name):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        b1p = state["beta1_pow"] * b1
        m = b1 * state["moment"] + (1 - b1) * g
        u = torch.maximum(b2 * state["inf_norm"], torch.abs(g) + eps)
        step = torch.div(b1p.new_tensor(lr), 1 - b1p)
        p.copy_(p - step * (m / u))
        state.update(moment=m, inf_norm=u, beta1_pow=b1p)


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _init_state(self, p):
        return {"moment": torch.full(p.shape, self._init_acc,
                                     dtype=_acc_dtype(p), device=p.device)}

    def _update(self, p, g, state, lr, wd, name):
        m = state["moment"] + g * g
        p.copy_(p - lr * g / (torch.sqrt(m) + self._epsilon))
        state["moment"] = m


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon, self._rho = epsilon, rho

    def _init_state(self, p):
        return {"avg_squared_grad": _acc_zeros(p),
                "avg_squared_update": _acc_zeros(p)}

    def _update(self, p, g, state, lr, wd, name):
        rho, eps = self._rho, self._epsilon
        asg = rho * state["avg_squared_grad"] + (1 - rho) * g * g
        upd = g * torch.sqrt(state["avg_squared_update"] + eps) / torch.sqrt(
            asg + eps)
        asu = rho * state["avg_squared_update"] + (1 - rho) * upd * upd
        p.copy_(p - lr * upd)
        state.update(avg_squared_grad=asg, avg_squared_update=asu)


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_state(self, p):
        s = {"mean_square": _acc_zeros(p), "momentum": _acc_zeros(p)}
        if self._centered:
            s["mean_grad"] = _acc_zeros(p)
        return s

    def _update(self, p, g, state, lr, wd, name):
        rho, eps = self._rho, self._epsilon
        ms = rho * state["mean_square"] + (1 - rho) * g * g
        if self._centered:
            mg = rho * state["mean_grad"] + (1 - rho) * g
            denom = torch.sqrt(ms - mg * mg + eps)
            state["mean_grad"] = mg
        else:
            denom = torch.sqrt(ms + eps)
        mom = self._momentum * state["momentum"] + lr * g / denom
        p.copy_(p - mom)
        state.update(mean_square=ms, momentum=mom)


class Lamb(Optimizer):
    """`exclude_from_weight_decay_fn(param)` sees the parameter with its
    `.name` set to the optimizer's key for it."""

    _elementwise = False

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9,
                 beta2=0.999, epsilon=1e-6, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_state(self, p):
        return {"moment1": _acc_zeros(p), "moment2": _acc_zeros(p),
                "beta1_pow": _ones(p), "beta2_pow": _ones(p)}

    def _update(self, p, g, state, lr, wd, name):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        b1p = state["beta1_pow"] * b1
        b2p = state["beta2_pow"] * b2
        m = b1 * state["moment1"] + (1 - b1) * g
        v = b2 * state["moment2"] + (1 - b2) * g * g
        mh = m / (1 - b1p)
        vh = v / (1 - b2p)
        r = mh / (torch.sqrt(vh) + eps)
        lamb_wd = self._lamb_wd
        if self._exclude_fn is not None and self._exclude_fn(
                _Named(name, p)):
            lamb_wd = 0.0
        upd = r + _weak(lamb_wd, p) * p
        w_norm, u_norm = _norm(p), _norm(upd)
        ratio = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            1.0)
        p.copy_(p - lr * ratio * upd)
        state.update(moment1=m, moment2=v, beta1_pow=b1p, beta2_pow=b2p)


class LarsMomentum(Optimizer):
    """LARS over momentum: local_lr = lr·coeff·‖p‖ / (‖g‖ + wd·‖p‖ + eps)
    (lr·coeff where a norm is 0), in f32. `exclude_from_weight_decay`
    name tags are matched against the parameter's key."""

    _elementwise = False

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 exclude_from_weight_decay=None, epsilon=1e-9):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._momentum = momentum
        self._coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._eps = epsilon
        self._exclude = list(exclude_from_weight_decay or [])

    def _init_state(self, p):
        return {"velocity": _acc_zeros(p)}

    def _update(self, p, g, state, lr, wd, name):
        lars_wd = self._lars_wd
        if any(tag in name for tag in self._exclude):
            lars_wd = 0.0
        p32, g32 = p.float(), g.float()
        p_norm, g_norm = _norm(p32), _norm(g32)
        local_lr = torch.where(
            (p_norm > 0) & (g_norm > 0),
            lr * self._coeff * p_norm
            / (g_norm + lars_wd * p_norm + self._eps),
            lr * self._coeff)
        v = self._momentum * state["velocity"] + local_lr * (
            g32 + lars_wd * p32)
        p.copy_(p32 - v)
        state["velocity"] = v
