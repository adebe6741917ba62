"""Pipelined (pp × mp) inference (counterpart of
paddle_tpu/distributed/fleet/utils/hybrid_parallel_inference.py).

The stage-decomposed model — a stage `block_fn` over this stage's
stacked parameters and a head — runs one fill-drain per call over the
stage processes: stage s forwards micro-batch m at tick m + s, the
activations go to the next stage over p2p, the last stage applies the
head, and its outputs are summed over ``pp`` (zeros elsewhere) so every
stage returns them. `generate` drives it one token at a time on the
host, as the reference's while-block does.
"""
import torch

__all__ = ["HybridParallelInferenceHelper"]


class HybridParallelInferenceHelper:
    """block_fn(stage_params, x) -> x: this rank's stage over its
    `stacked_params`; head_fn(x, post_params) -> logits on the last
    stage; micro_batches: the micro-batch count a batch is split into."""

    def __init__(self, block_fn, stacked_params, head_fn=None,
                 post_params=None, micro_batches=1):
        self._block_fn = block_fn
        self._stacked = stacked_params
        self._head_fn = head_fn or (lambda x, p: x)
        self._post = post_params
        self._M = int(micro_batches)

    @torch.no_grad()
    def forward(self, batch):
        """One pipelined forward over `batch`: the head's output on every
        stage. A batch not divisible by `micro_batches` is zero-padded to
        the next multiple and the padding stripped."""
        from ..meta_parallel.mp_ops import all_reduce_mp_raw
        from ..meta_parallel.pipeline_1f1b import (fill_drain,
                                                   last_stage_shape,
                                                   pp_world)

        x = torch.as_tensor(batch)
        n = x.shape[0]
        pad = (-n) % self._M
        if pad:
            x = torch.cat([x, torch.zeros((pad,) + tuple(x.shape[1:]),
                                          dtype=x.dtype, device=x.device)])
        xs = x.reshape((self._M, x.shape[0] // self._M) + tuple(x.shape[1:]))
        pp, stage, members = pp_world()
        if pp == 1:
            out = torch.stack([self._head_fn(self._block_fn(
                self._stacked, xm), self._post) for xm in xs])
            return out.reshape((x.shape[0],) + tuple(out.shape[2:]))[:n]
        outs = fill_drain(self._block_fn, self._stacked, xs, stage, pp,
                          members)
        out = None
        if outs is not None:
            out = torch.cat([self._head_fn(o, self._post) for o in outs])
        shape = last_stage_shape(None if out is None else tuple(out.shape))
        if out is None:
            out = torch.zeros(shape, dtype=torch.float32, device=x.device)
        return all_reduce_mp_raw(out.float(), axis="pp",
                                 kind="pp_outputs")[:n]

    def generate(self, prompt_fn, init_tokens, max_new_tokens,
                 sample_fn=None):
        """Greedy (or `sample_fn`) decoding through the pipeline:
        `prompt_fn(tokens) -> x` embeds the token window into the stage-0
        input; `sample_fn(logits) -> token` picks the next token (argmax
        of the last position by default)."""
        sample_fn = sample_fn or (lambda lg: torch.argmax(
            lg if lg.dim() == 2 else lg[..., -1, :], -1))
        toks = torch.as_tensor(init_tokens)
        for _ in range(max_new_tokens):
            logits = self.forward(prompt_fn(toks))
            nxt = sample_fn(logits)
            toks = torch.cat([toks, nxt[:, None].to(toks.dtype)], dim=1)
        return toks
