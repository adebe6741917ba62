"""Loss functionals (counterpart of paddle_tpu/nn/functional/loss.py).

`cross_entropy` runs hard labels through `_SoftmaxCECore`, the port of
the reference's memory-lean `_softmax_ce_core` (loss.py:55-92): f32 math
inside, only the logits (in their own dtype) and the per-row lse kept
for backward, the gradient returned in the logits' dtype.

`fused_linear_cross_entropy` / `linear_ce_raw` fuse the LM-head
projection with the softmax CE (loss.py:114-240): a loop over token
blocks, only the per-token lse saved, each block's logits recomputed in
backward, and the weight gradient carried in f32 whatever the weight's
dtype.
"""
import torch

from ... import amp

__all__ = ["cross_entropy", "fused_linear_cross_entropy", "linear_ce_raw"]


def _lse(lf):
    """Row logsumexp of f32 logits [..., V] (max-shifted)."""
    m = lf.amax(dim=-1)
    return m + torch.log(torch.exp(lf - m[..., None]).sum(dim=-1))


class _SoftmaxCECore(torch.autograd.Function):
    """Per-position softmax CE over the last axis: lse(logits) −
    logits[label]. No f32 [..., vocab] copy is kept for backward: it
    recomputes softmax from the saved logits and lse."""

    @staticmethod
    def forward(ctx, logits, labels):
        lf = logits.float()
        lse = _lse(lf)
        picked = lf.gather(-1, labels[..., None])[..., 0]
        ctx.save_for_backward(logits, labels, lse)
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        d = torch.exp(logits.float() - lse[..., None])
        d.scatter_add_(-1, labels[..., None],
                       torch.full(labels.shape + (1,), -1.0,
                                  device=d.device))
        d.mul_(g[..., None])
        return d.to(logits.dtype), None


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, name=None):
    """Softmax cross entropy over the last axis with hard (int) labels:
    `ignore_index` positions contribute 0, class `weight`s scale each
    position, and "mean" divides by the count of valid positions (or by
    their weight sum)."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    if soft_label or not use_softmax or axis not in (-1, input.ndim - 1):
        raise NotImplementedError(
            "cross_entropy with soft labels, without softmax or over a "
            "non-last axis is not ported yet (ROADMAP A12: remaining "
            "breadth)")
    input, weight = amp.cast_inputs_for("cross_entropy", (input, weight))
    lbl = label.long()
    if lbl.ndim == input.ndim:
        lbl = lbl.squeeze(-1)
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, 0)
    loss = torch.where(valid, _SoftmaxCECore.apply(input, safe), 0.0)
    if weight is not None:
        w = weight[safe]
        loss = loss * w
        if reduction == "mean":
            return loss.sum() / torch.clamp(
                (w * valid.to(loss.dtype)).sum(), min=1e-12)
    elif reduction == "mean":
        return loss.sum() / torch.clamp(valid.sum(), min=1).to(loss.dtype)
    return loss.sum() if reduction == "sum" else loss


def _block_logits(xi, w32, bias):
    # f32 products of the inputs (exact for bf16 operands) and f32
    # accumulation, as the reference's preferred_element_type=f32 dot
    return xi.float() @ w32 + bias.float()


class _LinearCE(torch.autograd.Function):
    """Mirrors `_linear_ce_core` (loss.py:114): per-row losses of
    x @ w + bias against `labels`, the [n, V] logits never kept."""

    @staticmethod
    def forward(ctx, x, w, bias, labels, block):
        n = x.shape[0]
        w32 = w.float()
        loss = torch.empty(n, dtype=torch.float32, device=x.device)
        lse = torch.empty_like(loss)
        for i in range(0, n, block):
            logits = _block_logits(x[i:i + block], w32, bias)
            lse[i:i + block] = _lse(logits)
            loss[i:i + block] = lse[i:i + block] - logits.gather(
                1, labels[i:i + block, None])[:, 0]
        ctx.save_for_backward(x, w, bias, labels, lse)
        ctx.block = block
        return loss

    @staticmethod
    def backward(ctx, g):
        x, w, bias, labels, lse = ctx.saved_tensors
        block = ctx.block
        w32 = w.float()
        dx = torch.empty_like(x)
        # the dw carry stays f32 whatever w's dtype: a bf16 carry would
        # round the running sum every block (reference loss.py:167-174)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        db = torch.zeros(bias.shape, dtype=torch.float32, device=w.device)
        for i in range(0, x.shape[0], block):
            xi = x[i:i + block]
            li = labels[i:i + block]
            d = torch.exp(_block_logits(xi, w32, bias)
                          - lse[i:i + block, None])
            d[torch.arange(li.shape[0], device=d.device), li] -= 1.0
            d.mul_(g[i:i + block, None])
            dl = d.to(w.dtype)      # the matmuls' operand in w's dtype
            dx[i:i + block] = dl @ w.t()
            dw += xi.float().t() @ dl.float()
            db += d.sum(dim=0)
        return dx, dw.to(w.dtype), db.to(bias.dtype), None, None


def linear_ce_raw(x2d, w, labels, block_size=4096, bias=None):
    """Per-row softmax CE of `x2d @ w (+ bias)` [n, V] against int
    `labels` [n], the logits never kept: rows are padded to a multiple
    of the block and processed block by block."""
    n = x2d.shape[0]
    if bias is None:
        bias = torch.zeros(w.shape[1], dtype=x2d.dtype, device=x2d.device)
    labels = labels.long()
    block = min(block_size, max(n, 1))
    npad = (-n) % block
    if npad:
        x2d = torch.nn.functional.pad(x2d, (0, 0, 0, npad))
        labels = torch.nn.functional.pad(labels, (0, npad))
    return _LinearCE.apply(x2d, w, bias, labels, block)[:n]


def fused_linear_cross_entropy(x, weight, label, bias=None,
                               transpose_weight=False, ignore_index=-100,
                               reduction="mean", block_size=4096, name=None):
    """Softmax CE of `x @ weight (+ bias)` without keeping the logits.
    `x` [..., d]; `weight` [d, V] (or [V, d] with `transpose_weight` —
    the tied-embedding layout); `label` [...] int class ids."""
    x, weight, bias = amp.cast_inputs_for("fused_linear_cross_entropy",
                                          (x, weight, bias))
    xf = x.reshape(-1, x.shape[-1])
    wf = weight.t() if transpose_weight else weight
    lf = label.reshape(-1).long()
    valid = lf != ignore_index
    safe = torch.where(valid, lf, 0)
    loss = linear_ce_raw(xf, wf, safe, block_size=block_size, bias=bias)
    loss = torch.where(valid, loss, 0.0)
    if reduction == "mean":
        return loss.sum() / torch.clamp(valid.sum(), min=1).to(loss.dtype)
    if reduction == "sum":
        return loss.sum()
    return loss.reshape(label.shape)
