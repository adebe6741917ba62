"""Loss functionals (counterpart of paddle_tpu/nn/functional/loss.py).

`cross_entropy` runs hard labels over the last axis through
`_SoftmaxCECore`, the port of the reference's memory-lean
`_softmax_ce_core` (loss.py:55-92): f32 math inside, only the logits (in
their own dtype) and the per-row lse kept for backward, the gradient
returned in the logits' dtype. Soft labels, probabilities
(`use_softmax=False`, clipped to [1e-15, 1] before the log) and another
`axis` take the reference's f32 log-softmax path, with its `weight`,
`ignore_index` and reduction rules in each mode.

The other losses follow the reference's definitions op for op,
including where they differ from torch's: `ctc_loss` takes
unnormalized logits [T, B, C] (log-softmax inside, as warpctc) and its
"mean" divides each loss by its label length; `hsigmoid_loss` walks the
complete-binary-tree code of the reference (or custom paths) and
averages the per-sample path sums; `margin_cross_entropy` is the
single-device ArcFace / CosFace margin softmax.

`fused_linear_cross_entropy` / `linear_ce_raw` fuse the LM-head
projection with the softmax CE (loss.py:114-240): a loop over token
blocks, only the per-token lse saved, each block's logits recomputed in
backward, and the weight gradient carried in f32 whatever the weight's
dtype.
"""
import numpy as np
import torch
import torch.nn.functional as tF

from ... import amp

__all__ = [
    "cross_entropy", "ctc_loss", "huber_loss", "poisson_nll_loss",
    "multi_label_soft_margin_loss", "softmax_with_cross_entropy",
    "nll_loss", "mse_loss", "l1_loss", "smooth_l1_loss",
    "binary_cross_entropy", "binary_cross_entropy_with_logits", "kl_div",
    "margin_ranking_loss", "hinge_embedding_loss", "cosine_embedding_loss",
    "triplet_margin_loss", "log_loss", "square_error_cost",
    "sigmoid_focal_loss", "dice_loss", "npair_loss", "soft_margin_loss",
    "triplet_margin_with_distance_loss", "hsigmoid_loss",
    "margin_cross_entropy", "fused_linear_cross_entropy", "linear_ce_raw",
]


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


def _softplus(x):
    """jax.nn.softplus: log(1 + exp(x)), with no linear cut-off."""
    return torch.logaddexp(x, torch.zeros_like(x))


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
    """Softmax cross entropy over `axis`. Hard (int) labels:
    `ignore_index` positions contribute 0, class `weight`s scale each
    position, and "mean" divides by the count of valid positions (or by
    their weight sum). Soft labels: -Σ label · log p over the axis
    (weighted per class, "mean" then over the summed label weights), the
    axis kept as size 1 under "none". `use_softmax=False` reads `input`
    as probabilities."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    input, weight = amp.cast_inputs_for("cross_entropy", (input, weight))
    ax = axis % input.ndim
    fused = not soft_label and use_softmax and ax == input.ndim - 1
    if not fused:
        logp = (torch.log_softmax(input.float(), dim=ax) if use_softmax
                else torch.log(torch.clamp(input.float(), 1e-15, 1.0)))
    if soft_label:
        if weight is not None:
            shape = [1] * logp.ndim
            shape[ax] = -1
            wb = weight.reshape(shape).to(logp.dtype)
            loss = -(label * wb * logp).sum(dim=ax)
            if reduction == "mean":
                denom = (label * wb).sum(dim=ax)
                return loss.sum() / torch.clamp(denom.sum(), min=1e-12)
        else:
            loss = -(label * logp).sum(dim=ax)
        if reduction == "none":
            loss = loss.unsqueeze(ax)
        return _reduce(loss, reduction)
    lbl = label.long()
    if lbl.ndim == input.ndim:
        lbl = lbl.squeeze(ax)
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, 0)
    if fused:
        loss = torch.where(valid, _SoftmaxCECore.apply(input, safe), 0.0)
    else:
        picked = logp.gather(ax, safe.unsqueeze(ax)).squeeze(ax)
        loss = torch.where(valid, -picked, 0.0)
    if weight is not None:
        w = weight[safe]
        loss = loss * w
        if reduction == "mean":
            return loss.sum() / torch.clamp(
                (w * valid.to(loss.dtype)).sum(), min=1e-12)
    elif reduction == "mean":
        return loss.sum() / torch.clamp(valid.sum(), min=1).to(loss.dtype)
    return loss.sum() if reduction == "sum" else loss


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """Per-position loss with the class axis kept as size 1 (and the
    softmax, with return_softmax)."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    if not soft_label:
        loss = loss.unsqueeze(axis)
    if return_softmax:
        from .activation import softmax

        return loss, softmax(logits, axis=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """Negative log-likelihood of log-probabilities [N, C, ...] at the
    labels [N, ...]."""
    input, weight = amp.cast_inputs_for("nll_loss", (input, weight))
    lbl = label.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, 0)
    picked = input.gather(1, safe.unsqueeze(1)).squeeze(1)
    loss = torch.where(valid, -picked, 0.0)
    if weight is not None:
        w = weight[safe] * valid.to(input.dtype)
        loss = loss * weight[safe]
        if reduction == "mean":
            return loss.sum() / torch.clamp(w.sum(), min=1e-12)
    elif reduction == "mean":
        return loss.sum() / torch.clamp(valid.sum(), min=1).to(loss.dtype)
    return _reduce(loss, reduction)


def mse_loss(input, label, reduction="mean", name=None):
    input, label = amp.cast_inputs_for("mse_loss", (input, label))
    return _reduce((input - label) ** 2, reduction)


def l1_loss(input, label, reduction="mean", name=None):
    input, label = amp.cast_inputs_for("l1_loss", (input, label))
    return _reduce((input - label).abs(), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    input, label = amp.cast_inputs_for("smooth_l1_loss", (input, label))
    d = input - label
    ad = d.abs()
    return _reduce(torch.where(ad < delta, 0.5 * d * d / delta,
                               ad - 0.5 * delta), reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    input, label, weight = amp.cast_inputs_for(
        "binary_cross_entropy", (input, label, weight))
    p = torch.clamp(input, 1e-12, 1.0 - 1e-12)
    out = -(label * torch.log(p) + (1 - label) * torch.log(1 - p))
    return _reduce(out if weight is None else out * weight, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    x, y, weight, pos_weight = amp.cast_inputs_for(
        "bce_with_logits", (logit, label, weight, pos_weight))
    soft = _softplus(-x.abs())
    if pos_weight is not None:
        log_w = (pos_weight - 1) * y + 1
        out = (1 - y) * x + log_w * (soft + torch.clamp(-x, min=0.0))
    else:
        out = torch.clamp(x, min=0) - x * y + soft
    return _reduce(out if weight is None else out * weight, reduction)


def kl_div(input, label, reduction="mean", name=None):
    input, label = amp.cast_inputs_for("kl_div", (input, label))
    out = torch.where(label > 0, label * (torch.log(
        torch.clamp(label, min=1e-12)) - input), 0.0)
    if reduction == "batchmean":
        return out.sum() / input.shape[0]
    return _reduce(out, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    input, other, label = amp.cast_inputs_for("margin_ranking_loss",
                                              (input, other, label))
    return _reduce(torch.clamp(-label * (input - other) + margin, min=0.0),
                   reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    input, label = amp.cast_inputs_for("hinge_embedding_loss",
                                       (input, label))
    return _reduce(torch.where(label == 1, input,
                               torch.clamp(margin - input, min=0.0)),
                   reduction)


def cosine_embedding_loss(input1, input2, label, margin=0, reduction="mean",
                          name=None):
    a, b, label = amp.cast_inputs_for("cosine_embedding_loss",
                                      (input1, input2, label))
    cos = (a * b).sum(-1) / torch.clamp(
        torch.linalg.vector_norm(a, dim=-1)
        * torch.linalg.vector_norm(b, dim=-1), min=1e-12)
    return _reduce(torch.where(label == 1, 1 - cos,
                               torch.clamp(cos - margin, min=0.0)),
                   reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    a, pos, neg = amp.cast_inputs_for("triplet_margin_loss",
                                      (input, positive, negative))

    def dist(u, v):
        return torch.linalg.vector_norm(u - v + epsilon, ord=p, dim=-1)

    dp, dn = dist(a, pos), dist(a, neg)
    if swap:
        dn = torch.minimum(dn, dist(pos, neg))
    return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)


def log_loss(input, label, epsilon=1e-4, name=None):
    p, y = amp.cast_inputs_for("log_loss", (input, label))
    return -y * torch.log(p + epsilon) - (1 - y) * torch.log(1 - p + epsilon)


def square_error_cost(input, label):
    input, label = amp.cast_inputs_for("square_error_cost", (input, label))
    return (input - label) ** 2


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    x, y, normalizer = amp.cast_inputs_for("sigmoid_focal_loss",
                                           (logit, label, normalizer))
    p = torch.sigmoid(x)
    ce = torch.clamp(x, min=0) - x * y + _softplus(-x.abs())
    p_t = p * y + (1 - p) * (1 - y)
    a_t = alpha * y + (1 - alpha) * (1 - y)
    out = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        out = out / normalizer
    return _reduce(out, reduction)


def huber_loss(input, label, delta=1.0, reduction="mean", name=None):
    input, label = amp.cast_inputs_for("huber_loss", (input, label))
    r = input - label
    a = r.abs()
    return _reduce(torch.where(a <= delta, 0.5 * r * r,
                               delta * (a - 0.5 * delta)), reduction)


def poisson_nll_loss(input, label, log_input=True, full=False,
                     epsilon=1e-8, reduction="mean", name=None):
    x, y = amp.cast_inputs_for("poisson_nll_loss", (input, label))
    out = (torch.exp(x) - y * x if log_input
           else x - y * torch.log(x + epsilon))
    if full:
        stir = (y * torch.log(y + epsilon) - y
                + 0.5 * torch.log(2 * np.pi * (y + epsilon)))
        out = out + torch.where(y > 1, stir, 0.0)
    return _reduce(out, reduction)


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean", name=None):
    x, y, weight = amp.cast_inputs_for("multi_label_soft_margin",
                                       (input, label, weight))
    term = y * tF.logsigmoid(x) + (1 - y) * tF.logsigmoid(-x)
    if weight is not None:
        term = term * weight
    return _reduce(-term.mean(dim=-1), reduction)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC over unnormalized logits [T, B, C] (log-softmax inside);
    labels [B, L]; lengths per sample. The alpha recursion in the log
    semiring over the extended labels (blank, l1, blank, ..., blank)."""
    (logits,) = amp.cast_inputs_for("ctc_loss", (log_probs,))
    il = torch.as_tensor(input_lengths, device=logits.device).long()
    ll = torch.as_tensor(label_lengths, device=logits.device).long()
    T, B, _ = logits.shape
    lab = labels.long()
    S = 2 * lab.shape[1] + 1
    lp = torch.log_softmax(logits, dim=-1)
    ext = torch.full((B, S), blank, dtype=torch.long, device=lab.device)
    ext[:, 1::2] = lab
    neg = torch.tensor(-1e30, dtype=lp.dtype, device=lp.device)
    ext_m2 = tF.pad(ext, (2, 0), value=-1)[:, :S]
    can_skip = (ext != blank) & (ext != ext_m2)
    pos = torch.arange(S, device=lp.device)[None, :]
    alpha = torch.where(pos < 2, lp[0].gather(1, ext), neg)
    for t in range(1, T):
        prev1 = tF.pad(alpha, (1, 0), value=-1e30)[:, :S]
        prev2 = torch.where(can_skip,
                            tF.pad(alpha, (2, 0), value=-1e30)[:, :S], neg)
        new = (torch.logaddexp(torch.logaddexp(alpha, prev1), prev2)
               + lp[t].gather(1, ext))
        alpha = torch.where((t < il)[:, None], new, alpha)
    end_blank = alpha.gather(1, (2 * ll)[:, None])[:, 0]
    end_label = alpha.gather(1, torch.clamp(2 * ll - 1, min=0)[:, None])[:, 0]
    nll = torch.where(ll > 0, -torch.logaddexp(end_blank, end_label),
                      -end_blank)
    if norm_by_times:
        nll = nll / torch.clamp(il, min=1).to(nll.dtype)
    if reduction == "mean":
        return (nll / torch.clamp(ll, min=1).to(torch.float32)).mean()
    if reduction == "sum":
        return nll.sum()
    return nll


def dice_loss(input, label, epsilon=1e-5, name=None):
    """1 - 2|X ∩ Y| / (|X| + |Y|) per sample over the class (last) axis,
    averaged."""
    (x,) = amp.cast_inputs_for("dice_loss", (input,))
    lbl = label.long()
    if lbl.ndim == x.ndim:
        lbl = lbl.squeeze(-1)
    onehot = (lbl[..., None] == torch.arange(x.shape[-1],
                                             device=x.device)).to(x.dtype)
    dims = tuple(range(1, x.ndim))
    inse = (x * onehot).sum(dim=dims)
    denom = x.sum(dim=dims) + onehot.sum(dim=dims)
    return (1.0 - 2.0 * inse / (denom + epsilon)).mean()


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    a, p = amp.cast_inputs_for("npair_loss", (anchor, positive))
    lbl = labels.reshape(-1).float()
    eq = (lbl[:, None] == lbl[None, :]).to(a.dtype)
    targets = eq / torch.clamp(eq.sum(-1, keepdim=True), min=1e-12)
    logp = torch.log_softmax((a @ p.T).float(), dim=-1)
    ce = (-targets * logp).sum(dim=-1).mean()
    return ce + ((a * a).sum() + (p * p).sum()) / a.shape[0] * l2_reg * 0.25


def soft_margin_loss(input, label, reduction="mean", name=None):
    (x,) = amp.cast_inputs_for("soft_margin_loss", (input,))
    return _reduce(torch.log1p(torch.exp(-label.to(x.dtype) * x)),
                   reduction)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    from .common import pairwise_distance

    dist = distance_function or pairwise_distance
    dp, dn = dist(input, positive), dist(input, negative)
    if swap:
        dn = torch.minimum(dn, dist(positive, negative))
    return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)


def _hsigmoid_default_paths(num_classes):
    """Per-class (node index, bit) tables of the complete-binary-tree
    code: c = label + num_classes, node(bit) = (c >> (bit + 1)) - 1,
    bit(bit) = (c >> bit) & 1, over floor(log2 c) bits (-1 padded)."""
    max_len = int(np.floor(np.log2(2 * num_classes - 1)))
    table = np.full((num_classes, max_len), -1, np.int64)
    code = np.zeros((num_classes, max_len), np.float32)
    for cls in range(num_classes):
        c = cls + num_classes
        for bit in range(int(np.floor(np.log2(c)))):
            table[cls, bit] = (c >> (bit + 1)) - 1
            code[cls, bit] = float((c >> bit) & 1)
    return table, code


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid: the binary decisions along each label's
    path (the default tree's, or custom `path_table` / `path_code` [N, L]
    -1 padded), softplus(z) - bit · z summed per sample, then averaged."""
    x, weight, bias = amp.cast_inputs_for("hsigmoid_loss",
                                          (input, weight, bias))
    if path_table is not None:
        tbl = torch.as_tensor(path_table, device=x.device).long()
        bits = torch.as_tensor(path_code, device=x.device).float()
    else:
        table, code = _hsigmoid_default_paths(int(num_classes))
        lbl = label.reshape(-1).long().cpu()
        tbl = torch.from_numpy(table)[lbl].to(x.device)
        bits = torch.from_numpy(code)[lbl].to(x.device)
    valid = tbl >= 0
    safe = torch.where(valid, tbl, 0)
    ct = torch.promote_types(x.dtype, torch.float32)
    z = torch.einsum("nd,nld->nl", x.to(ct), weight[safe].to(ct))
    if bias is not None:
        z = z + bias.reshape(-1)[safe]
    per_node = torch.where(valid, _softplus(z) - bits * z, 0.0)
    return per_node.sum(dim=-1, keepdim=True).mean()


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean"):
    """ArcFace / CosFace margin softmax CE over cosine logits: the label
    class's cosine becomes cos(m1·θ + m2) - m3 before the scale."""
    (cos,) = amp.cast_inputs_for("margin_cross_entropy", (logits,))
    lbl = label.reshape(-1).long()
    cf = cos.to(torch.promote_types(cos.dtype, torch.float32))
    hit = torch.arange(cf.shape[-1], device=cf.device) == lbl[:, None]
    theta = torch.arccos(torch.clamp(cf, -1.0 + 1e-7, 1.0 - 1e-7))
    modified = torch.cos(margin1 * theta + margin2) - margin3
    logp = torch.log_softmax(torch.where(hit, modified, cf) * scale, dim=-1)
    out = _reduce(-logp.gather(-1, lbl[:, None]), reduction)
    return (out, torch.exp(logp)) if return_softmax else out


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
