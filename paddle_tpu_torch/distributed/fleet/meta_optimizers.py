"""Fleet strategy meta-optimizers: LARS, LocalSGD, DGC (counterpart of
paddle_tpu/distributed/fleet/meta_optimizers.py).

Each strategy is a small runtime object over the port's optimizer
protocol (`_update` in place per parameter) and the eager host
collectives (`xproc`):

* `lars(...)` — the core `optimizer.LarsMomentum`;
* `LocalSGD` — workers step locally; every `k_steps` calls the
  parameters are averaged across the trainer processes (`adaptive`
  grows or shrinks k with the post-sync drift, the same on every rank);
* `DGCMomentum` — deep gradient compression: error-feedback top-k
  sparsified update with momentum correction and momentum-factor
  masking; across processes only (index, value) pairs travel (int32
  indices), scatter-summed in float64 and divided by the world size.
"""
import math

import numpy as np
import torch

from ...optimizer.optimizer import Momentum, _acc_zeros
from .. import xproc

__all__ = ["lars", "LocalSGD", "DGCMomentum"]


def lars(learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
         lars_weight_decay=0.0005, parameters=None, **kw):
    """Strategy entry: the LARS update is `optimizer.LarsMomentum`."""
    from ...optimizer import LarsMomentum

    return LarsMomentum(learning_rate, momentum, lars_coeff,
                        lars_weight_decay, parameters=parameters, **kw)


class LocalSGD:
    """Periodic parameter averaging across trainer processes.

        sync = LocalSGD(model, k_steps=4)
        for batch in loader:
            train_step(batch)          # any local step
            sync.step()                # averages params every k-th call

    Single-process jobs: step() is a no-op."""

    def __init__(self, model, k_steps=1, adaptive=False, min_k=1,
                 max_k=16, drift_threshold=1e-3):
        self.model = model  # an nn.Module OR a plain parameter list
        self.k_steps = max(1, int(k_steps))
        self.adaptive = adaptive
        self.min_k, self.max_k = min_k, max_k
        self.drift_threshold = drift_threshold
        self._calls = 0
        self.syncs = 0

    def step(self):
        self._calls += 1
        if self._calls % self.k_steps:
            return False
        if not xproc.is_multiprocess():
            return False
        params = (list(self.model) if isinstance(self.model, (list, tuple))
                  else [p for _, p in self.model.named_parameters()])
        drift = 0.0
        with torch.no_grad():
            for p in params:
                t = p.detach()
                local = (t.float() if t.dtype == torch.bfloat16
                         else t).cpu().numpy()
                avg = xproc.all_reduce_np(local, op="avg")
                if self.adaptive:
                    drift = max(drift, float(np.max(np.abs(avg - local))))
                p.copy_(torch.from_numpy(np.ascontiguousarray(avg)).to(
                    device=p.device, dtype=p.dtype))
        self.syncs += 1
        if self.adaptive:
            # every rank adapts from the SAME drift, or the sync
            # schedules desynchronize and collectives cross-pair
            drift = float(xproc.all_reduce_np(
                np.array([drift], np.float32), op="max")[0])
            if drift < self.drift_threshold and self.k_steps < self.max_k:
                self.k_steps = min(self.max_k, self.k_steps * 2)
            elif drift > 10 * self.drift_threshold and \
                    self.k_steps > self.min_k:
                self.k_steps = max(self.min_k, self.k_steps // 2)
        return True


class DGCMomentum(Momentum):
    """Deep-gradient-compression momentum. Per parameter: u ← m·u + g,
    v ← v + u; the top (1 − sparsity) entries of |v| are this step's
    sparse update and are zeroed in v (error feedback) and in u
    (momentum-factor masking). `sparsity` is the fraction of entries
    DROPPED (the reference's default 0.999 keeps 0.1 %); sparsity 0
    degenerates to plain SGD."""

    _elementwise = False

    def __init__(self, learning_rate=0.001, momentum=0.9, sparsity=0.999,
                 parameters=None, grad_clip=None, name=None):
        super().__init__(learning_rate, momentum, parameters,
                         grad_clip=grad_clip)
        if not 0.0 <= float(sparsity) < 1.0:
            raise ValueError(f"sparsity (fraction dropped) must be in "
                             f"[0, 1), got {sparsity}")
        self.sparsity = float(sparsity)

    def _init_state(self, p):
        return {"u": _acc_zeros(p), "v": _acc_zeros(p)}

    def _update(self, p, g, state, lr, wd, name):
        if wd:
            g = g + wd * p
        u = self._momentum * state["u"] + g
        v = state["v"] + u
        flat = v.reshape(-1)
        k = max(1, int(math.ceil((1.0 - self.sparsity) * flat.numel())))
        idx = torch.topk(flat.abs(), k).indices
        vals = flat[idx]
        if xproc.is_multiprocess():
            if flat.numel() >= 2 ** 31:
                raise NotImplementedError(
                    "DGC index transport is int32; parameter has "
                    f"{flat.numel()} elements")
            g_idx = xproc.all_gather_np(idx.cpu().numpy().astype(np.int32))
            g_val = xproc.all_gather_np(
                vals.float().cpu().numpy().astype(np.float32))
            dense = np.zeros(flat.numel(), np.float64)
            world = g_idx.shape[0]
            for r in range(world):
                np.add.at(dense, g_idx[r].astype(np.int64),
                          g_val[r].astype(np.float64))
            update = torch.from_numpy(dense / world).to(
                device=flat.device, dtype=flat.dtype)
        else:
            update = torch.zeros_like(flat).index_put_((idx,), vals)
        new_v = flat.clone().index_put_((idx,), torch.zeros_like(vals))
        new_u = u.reshape(-1).clone().index_put_((idx,),
                                                 torch.zeros_like(vals))
        p.copy_(p - lr * update.reshape(p.shape))
        state["u"] = new_u.reshape(u.shape)
        state["v"] = new_v.reshape(v.shape)
