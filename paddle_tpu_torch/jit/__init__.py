"""Train steps (counterpart of paddle_tpu/jit, `TrainStep` at
jit/__init__.py:440).

The reference compiles loss + backward + optimizer update into one XLA
program over the parameter pytree. PyTorch runs eagerly, so the port's
`TrainStep` is one eager step per call: clear the gradients, run
`loss_fn(model, *batch)` under the step's dropout generator, backward,
and the optimizer update applied to the parameters in place (the port's
counterpart of donating them). No compile cache, signatures or
telemetry; `num_batch_signatures` counts the distinct batch shapes seen.
"""
import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core import rng
from ..distributed.fleet.recompute import (checkpoint_policy,
                                          rng_replay_contexts)

__all__ = ["TrainStep"]


class TrainStep:
    """loss_fn(model, *batch) -> scalar loss tensor. Each call takes one
    optimizer step and returns the loss (detached).

    remat=True recomputes the whole loss function in backward (keep
    nothing); a named jax policy raises. donate_params=False keeps the
    tensors that held the parameters before a step unchanged (each step
    writes the update into fresh storage)."""

    def __init__(self, model, loss_fn, optimizer, donate_params=True,
                 remat=False):
        checkpoint_policy(remat)
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.donate_params = donate_params
        self.remat = remat
        self._params = [p for p in model.parameters() if p.requires_grad]
        self._batch_signatures = set()

    @property
    def num_batch_signatures(self):
        """Distinct batch (shape, dtype) signatures seen."""
        return len(self._batch_signatures)

    def __call__(self, *batch):
        device = self._params[0].device
        batch = [b if isinstance(b, torch.Tensor)
                 else torch.as_tensor(np.asarray(b), device=device)
                 for b in batch]
        self._batch_signatures.add(
            tuple((tuple(b.shape), str(b.dtype)) for b in batch))
        self.optimizer.clear_grad()
        with rng.generator_scope(rng.next_generator(device)):
            if self.remat:
                loss = checkpoint(lambda *b: self.loss_fn(self.model, *b),
                                  *batch, use_reentrant=False,
                                  context_fn=rng_replay_contexts)
            else:
                loss = self.loss_fn(self.model, *batch)
        loss.backward()
        for p in self._params:
            # the compiled reference step updates every trainable leaf
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            if not self.donate_params:
                p.data = p.data.clone()
        self.optimizer.step()
        return loss.detach()
