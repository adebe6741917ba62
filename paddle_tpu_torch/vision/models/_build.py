"""Where a vision model is built: its layers are made on the CPU under
one generator seeded from the model's `seed` (every initializer draws
from it, so one seed gives the same weights whatever the device), then
the model moves to its device, CUDA unless the caller asks for the
CPU."""
import contextlib

import torch

from ...core import rng
from ...core.place import resolve_device

__all__ = ["seeded_build", "place"]


@contextlib.contextmanager
def seeded_build(seed):
    """Initializers inside draw from a CPU generator seeded from `seed`;
    None keeps the enclosing scope's generator."""
    if seed is None:
        yield
        return
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed))
    with rng.generator_scope(gen):
        yield


def place(model, device):
    """`model` moved to `device` (None: CUDA, raising without a GPU)."""
    return model.to(device=resolve_device(device))
