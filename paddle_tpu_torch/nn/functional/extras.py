"""Functional extras (counterpart of paddle_tpu/nn/functional/extras.py):
the beam-search backtrace."""
import torch

__all__ = ["gather_tree"]


def gather_tree(ids, parents):
    """Beam-search backtrace: walk the parent pointers back from the last
    step, so each beam holds its whole ancestry. ids / parents
    [max_time, batch, beam] → [max_time, batch, beam]."""
    steps, batch, beam = ids.shape
    sel = torch.arange(beam, device=ids.device).expand(batch, beam)
    out = []
    for t in range(steps - 1, -1, -1):
        out.append(torch.gather(ids[t], 1, sel))
        sel = torch.gather(parents[t], 1, sel)
    return torch.stack(out[::-1])
