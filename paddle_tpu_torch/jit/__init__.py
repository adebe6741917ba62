"""Train steps (counterpart of paddle_tpu/jit, `TrainStep` at
jit/__init__.py:440).

The reference compiles loss + backward + optimizer update into one XLA
program over the parameter pytree. PyTorch runs eagerly, so the port's
`TrainStep` is one eager step per call: clear the gradients, run
`loss_fn(model, *batch)` under the step's dropout generator, backward,
and the optimizer update applied to the parameters in place (the port's
counterpart of donating them). The update is the compiled step's
(`Optimizer._train_step_update`): `grad_clip` spans every parameter at
once, not each param group on its own as the eager `step()` does.

Telemetry is the reference's (:614-737): each step's phases are stamped
into `observability.steptrace` (`h2d` once the batch is on the device,
`dispatch` once forward, backward and update are enqueued, `device_step`
after a `torch.cuda.synchronize` taken only when steptrace is active,
`opt_publish`); a step with a new batch signature runs quiet, and
signatures past the first fire the recompile sentinel; the metrics
`pt_train_step_seconds`, `pt_train_steps_total` and
`pt_train_compiles_total` (here: new batch signatures), and in full mode
`pt_train_loss` and `pt_train_grad_norm` (the f32 global L2 norm of the
raw gradients, before any clipping, as the reference's aux output). The
plane only observes the step: losses are bit-identical in every mode.
The reference's `profiler.benchmark()` ips meter belongs to the
profiler, which is not ported yet (ROADMAP A12).

Batch norm's running statistics are updated in place by the forward,
once a step: under `remat` the recompute in backward skips the update
(`core.recompute`), as the reference's step writes its frozen state back
once whatever `jax.checkpoint` recomputes.

`HybridTrainStep` (hybrid_step.py) is the DP × TP × PP step over the
process mesh.
"""
import time
import warnings

import numpy as np
import torch

from ..core import rng
from ..observability import metrics as _obs
from ..observability import steptrace as _steptrace
from ..observability.tracing import trace_span as _trace_span

__all__ = ["TrainStep", "HybridTrainStep"]

# runtime telemetry, under the reference's metric names
_STEP_SECONDS = _obs.histogram(
    "pt_train_step_seconds", "compiled train-step wall time")
_STEPS_TOTAL = _obs.counter(
    "pt_train_steps_total", "compiled train steps dispatched")
_COMPILES_TOTAL = _obs.counter(
    "pt_train_compiles_total",
    "distinct TrainStep batch signatures seen — each is one XLA "
    "compile; growth after warmup is recompile churn")
_LOSS_GAUGE = _obs.gauge(
    "pt_train_loss", "last loss (full telemetry only: syncs the device)")
_GRAD_NORM = _obs.histogram(
    "pt_train_grad_norm",
    "global grad L2 norm per step (full telemetry only)",
    buckets=(0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0,
             100.0, 300.0, 1000.0))


class TrainStep:
    """loss_fn(model, *batch) -> scalar loss tensor. Each call takes one
    optimizer step and returns the loss (detached).

    remat: False → off; True → recompute the whole loss function in
    backward (keep nothing); a policy name (`dots_saveable`, ...) or a
    torch SAC policy → what `fleet.recompute.checkpoint_policy` maps it
    to. donate_params=False keeps the tensors that held the parameters
    before a step unchanged (each step writes the update into fresh
    storage)."""

    def __init__(self, model, loss_fn, optimizer, donate_params=True,
                 remat=False):
        # distributed/ imports this module: load the recompute on use
        from ..distributed.fleet.recompute import checkpoint_policy

        self._policy = checkpoint_policy(remat)
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.donate_params = donate_params
        self.remat = remat
        self._params = [p for p in model.parameters() if p.requires_grad]
        self._batch_signatures = set()
        self._sig_warned = False
        self.max_batch_signatures = 8
        # the previous step's last stamp: the next step's data_wait anchor
        self._steptrace_prev_end = None

    @property
    def num_batch_signatures(self):
        """Distinct batch (shape, dtype) signatures seen."""
        return len(self._batch_signatures)

    def _loss(self, batch):
        from ..distributed.fleet.recompute import run_with_policy

        if not self.remat:
            return self.loss_fn(self.model, *batch)
        return run_with_policy(lambda *b: self.loss_fn(self.model, *b),
                               batch, self._policy)

    def _note_signature(self, batch):
        """True when `batch` has a new signature (the step runs quiet)."""
        sig = tuple((tuple(b.shape), str(b.dtype)) for b in batch)
        if sig in self._batch_signatures:
            return False
        self._batch_signatures.add(sig)
        _COMPILES_TOTAL.inc()
        if len(self._batch_signatures) > 1:
            _steptrace.note_recompile(
                "train", step=int(self.optimizer._step_count),
                signatures=len(self._batch_signatures), batch_sig=repr(sig))
        if (len(self._batch_signatures) == self.max_batch_signatures + 1
                and not self._sig_warned):
            self._sig_warned = True
            warnings.warn(
                f"TrainStep has now seen {len(self._batch_signatures)} "
                "distinct batch shapes; variable-length data should be "
                "bucketed to a few padded lengths.",
                RuntimeWarning, stacklevel=3)
        return True

    def __call__(self, *batch):
        t_entry = _steptrace.now()
        device = self._params[0].device
        batch = [b if isinstance(b, torch.Tensor)
                 else torch.as_tensor(np.asarray(b), device=device)
                 for b in batch]
        t_h2d = _steptrace.now()
        quiet = self._note_signature(batch)
        full = _obs._STATE.mode >= _obs._STATE.FULL
        step_idx = int(self.optimizer._step_count)
        tr = _steptrace.begin_step("train", step_idx,
                                   prev_end=self._steptrace_prev_end,
                                   quiet=quiet, t_entry=t_entry)
        tr.stamp("h2d", t_h2d)
        _steptrace.chaos_fire("step.dispatch")
        t0 = time.perf_counter()
        grad_norm = None
        with _trace_span("jit.TrainStep", step=step_idx):
            self.optimizer.clear_grad()
            with rng.generator_scope(rng.next_generator(device)):
                loss = self._loss(batch)
            loss.backward()
            for p in self._params:
                # the compiled reference step updates every trainable leaf
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                if not self.donate_params:
                    p.data = p.data.clone()
            if full:
                # the raw gradients' global norm, before any clipping
                grad_norm = torch.sqrt(sum(
                    (p.grad.float() ** 2).sum() for p in self._params))
            self.optimizer._train_step_update(self._params)
        tr.stamp("dispatch")
        if _steptrace.active():
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            tr.stamp("device_step")
        _STEP_SECONDS.observe(time.perf_counter() - t0)
        _STEPS_TOTAL.inc()
        loss = loss.detach()
        if grad_norm is not None:
            # full telemetry accepts the device sync these reads force
            _LOSS_GAUGE.set(float(loss))
            _GRAD_NORM.observe(float(grad_norm))
        tr.stamp("opt_publish")
        _, self._steptrace_prev_end = _steptrace.end_step(tr)
        return loss


def __getattr__(name):
    # HybridTrainStep reaches into distributed/, which imports this
    # module: load it on first use
    if name == "HybridTrainStep":
        from .hybrid_step import HybridTrainStep

        return HybridTrainStep
    raise AttributeError(name)
