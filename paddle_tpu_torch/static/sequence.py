"""Sequence (LoD) op family (counterpart of paddle_tpu/static/sequence.py;
reference paddle/fluid/operators/sequence_ops/ + the LoDTensor model,
paddle/fluid/framework/lod_tensor.h).

Variable-length sequences are stored flat, with level-of-detail offsets:
a `LoDTensor` is a torch tensor carrying `lod` (one level; rows
offsets[i]..offsets[i+1] are sequence i). Each op is segment arithmetic
over the flat rows: index gathers built on the host from the offsets,
then gathers, `index_add_` sums and `scatter_reduce` max / min on the
tensor's device.
"""
import numpy as np
import torch

from .nn_build import _t

__all__ = [
    "LoDTensor", "sequence_concat", "sequence_conv", "sequence_enumerate",
    "sequence_expand", "sequence_expand_as", "sequence_first_step",
    "sequence_last_step", "sequence_pad", "sequence_pool",
    "sequence_reshape", "sequence_reverse", "sequence_scatter",
    "sequence_slice", "sequence_softmax", "sequence_unpad",
]


class LoDTensor(torch.Tensor):
    """Flat sequence batch + offsets (reference lod_tensor.h: one LoD
    level). `LoDTensor(value, lod)` views `value` (keeping its autograd
    history); ops on it return plain tensors."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    @staticmethod
    def __new__(cls, value, lod, stop_gradient=True, name=None):
        t = torch.as_tensor(value if isinstance(value, torch.Tensor)
                            else np.asarray(value)).as_subclass(cls)
        t.lod = [int(v) for v in lod]
        return t

    def __init__(self, value, lod, stop_gradient=True, name=None):
        pass

    @property
    def seq_lengths(self):
        return [self.lod[i + 1] - self.lod[i]
                for i in range(len(self.lod) - 1)]


def _as_lod(x, lod=None):
    if isinstance(x, LoDTensor):
        return x
    if lod is None:
        raise ValueError("sequence op needs a LoDTensor (or explicit lod)")
    return LoDTensor(_t(x), lod)


def _plain(x):
    return x.as_subclass(torch.Tensor) if isinstance(x, LoDTensor) else x


def _index(idx, like):
    return torch.as_tensor(np.asarray(idx, np.int64), device=like.device)


def _seg_ids(lod):
    n = len(lod) - 1
    return np.repeat(np.arange(n), np.diff(np.asarray(lod)))


def _seg_reduce(v, seg, n, how):
    out_shape = (n,) + tuple(v.shape[1:])
    idx = seg.reshape((-1,) + (1,) * (v.dim() - 1)).expand_as(v)
    if how == "sum":
        return torch.zeros(out_shape, dtype=v.dtype,
                           device=v.device).index_add_(0, seg, v)
    # an empty segment keeps the identity the reference's segment ops
    # give it (-inf for max, +inf for min)
    fill = float("-inf") if how == "amax" else float("inf")
    base = torch.full(out_shape, fill, dtype=v.dtype, device=v.device)
    return base.scatter_reduce(0, idx, v, reduce=how, include_self=True)


def sequence_pool(input, pool_type, is_test=False, pad_value=0.0):
    """Per-sequence reduction (reference sequence_ops/sequence_pool_op.cc):
    sum / average / sqrt / max / min / first / last; an empty sequence
    gives pad_value."""
    x = _as_lod(input)
    lod = x.lod
    v = _plain(x)
    n = len(lod) - 1
    seg = _index(_seg_ids(lod), v)
    lens = np.maximum(np.diff(np.asarray(lod)), 1)
    bshape = (-1,) + (1,) * (v.dim() - 1)
    pool_type = pool_type.lower()
    if pool_type == "sum":
        out = _seg_reduce(v, seg, n, "sum")
    elif pool_type == "average":
        out = _seg_reduce(v, seg, n, "sum") / _index(lens, v).reshape(bshape)
    elif pool_type == "sqrt":
        out = _seg_reduce(v, seg, n, "sum") / torch.sqrt(
            _index(lens, v).to(v.dtype)).reshape(bshape)
    elif pool_type == "max":
        out = _seg_reduce(v, seg, n, "amax")
    elif pool_type == "min":
        out = _seg_reduce(v, seg, n, "amin")
    elif pool_type == "first":
        out = v[_index(lod[:-1], v)]
    elif pool_type == "last":
        out = v[_index(np.maximum(np.asarray(lod[1:]) - 1, 0), v)]
    else:
        raise ValueError(f"unknown pool_type {pool_type}")
    if any(ln == 0 for ln in x.seq_lengths):
        empty = torch.as_tensor(np.asarray(x.seq_lengths) == 0,
                                device=v.device).reshape(bshape)
        out = torch.where(empty, torch.as_tensor(pad_value, dtype=out.dtype,
                                                 device=v.device), out)
    return out


def sequence_first_step(input):
    return sequence_pool(input, "first")


def sequence_last_step(input):
    return sequence_pool(input, "last")


def sequence_softmax(input, use_cudnn=False, name=None):
    """Softmax within each sequence over the flat rows (reference
    sequence_softmax_op)."""
    x = _as_lod(input)
    v = _plain(x)
    n = len(x.lod) - 1
    seg = _index(_seg_ids(x.lod), v)
    flat = v.reshape(-1)
    mx = _seg_reduce(flat, seg, n, "amax")
    e = torch.exp(flat - mx[seg])
    s = _seg_reduce(e, seg, n, "sum")
    return LoDTensor((e / s[seg]).reshape(v.shape), x.lod)


def sequence_reverse(x, name=None):
    """Reverse rows within each sequence (reference sequence_reverse_op)."""
    t = _as_lod(x)
    idx = []
    for i in range(len(t.lod) - 1):
        idx.extend(range(t.lod[i + 1] - 1, t.lod[i] - 1, -1))
    v = _plain(t)
    return LoDTensor(v[_index(idx, v)], t.lod)


def sequence_concat(input, name=None):
    """Concat same-count LoD batches sequence-wise (reference
    sequence_concat_op)."""
    xs = [_as_lod(x) for x in input]
    n = len(xs[0].lod) - 1
    order = []
    offset_base = [0]
    for x in xs:
        offset_base.append(offset_base[-1] + x.lod[-1])
    new_lod = [0]
    for i in range(n):
        total = 0
        for xi, x in enumerate(xs):
            order.extend(offset_base[xi] + r
                         for r in range(x.lod[i], x.lod[i + 1]))
            total += x.lod[i + 1] - x.lod[i]
        new_lod.append(new_lod[-1] + total)
    cat = torch.cat([_plain(x) for x in xs], 0)
    return LoDTensor(cat[_index(order, cat)], new_lod)


def sequence_pad(x, pad_value, maxlen=None, name=None):
    """LoD → (padded [N, L, ...], lengths) (reference sequence_pad_op)."""
    t = _as_lod(x)
    v = _plain(t)
    lens = np.asarray(t.seq_lengths)
    L = int(maxlen) if maxlen is not None else int(lens.max() if
                                                  len(lens) else 0)
    n = len(lens)
    # gather index per (seq, slot); padded slots read row 0, then masked
    gidx = np.zeros((n, L), np.int64)
    mask = np.zeros((n, L), bool)
    for i in range(n):
        ln = min(int(lens[i]), L)
        gidx[i, :ln] = np.arange(t.lod[i], t.lod[i] + ln)
        mask[i, :ln] = True
    padded = v[_index(gidx.reshape(-1), v)].reshape((n, L) + v.shape[1:])
    m = torch.as_tensor(mask, device=v.device).reshape(
        (n, L) + (1,) * (v.dim() - 1))
    pv = _t(pad_value).to(device=v.device, dtype=v.dtype)
    return (torch.where(m, padded, pv),
            torch.as_tensor(lens.astype(np.int64), device=v.device))


def sequence_unpad(x, length, name=None):
    """(padded, lengths) → flat LoD rows (reference sequence_unpad_op)."""
    t = _plain(_t(x))
    lens = np.asarray(_t(length).cpu()).astype(np.int64)
    n, L = t.shape[0], t.shape[1]
    rows = []
    lod = [0]
    for i in range(n):
        ln = int(min(lens[i], L))
        rows.extend(i * L + j for j in range(ln))
        lod.append(lod[-1] + ln)
    flat = t.reshape((n * L,) + tuple(t.shape[2:]))
    return LoDTensor(flat[_index(rows, flat)], lod)


def sequence_expand(x, y, ref_level=-1, name=None):
    """Repeat x's sequences per y's LoD (reference sequence_expand_op):
    sequence i of x is tiled y_len_i times; a non-LoD x has one
    length-1 sequence per row."""
    if isinstance(x, LoDTensor):
        xt = x
    else:
        xt = _as_lod(x, list(range(int(_t(x).shape[0]) + 1)))
    reps = _as_lod(y).seq_lengths
    order = []
    new_lod = [0]
    for i in range(len(xt.lod) - 1):
        seq = list(range(xt.lod[i], xt.lod[i + 1]))
        r = reps[i] if i < len(reps) else 1
        for _ in range(max(r, 0)):
            order.extend(seq)
        new_lod.append(len(order))
    v = _plain(xt)
    return LoDTensor(v[_index(order, v)], new_lod)


def sequence_expand_as(x, y, name=None):
    """Expand each row of x to match y's sequence lengths (reference
    sequence_expand_as_op)."""
    v = _plain(_t(x))
    reps = _as_lod(y).seq_lengths
    order = []
    new_lod = [0]
    for i, r in enumerate(reps):
        order.extend([i] * r)
        new_lod.append(len(order))
    return LoDTensor(v[_index(order, v)], new_lod)


def sequence_reshape(input, new_dim):
    """Re-chunk each sequence's flattened payload to rows of new_dim
    (reference sequence_reshape_op)."""
    t = _as_lod(input)
    d = int(t.shape[-1])
    new_lod = [0]
    for ln in t.seq_lengths:
        total = ln * d
        if total % new_dim != 0:
            raise ValueError("sequence payload not divisible by new_dim")
        new_lod.append(new_lod[-1] + total // new_dim)
    return LoDTensor(_plain(t).reshape(-1, new_dim), new_lod)


def sequence_slice(input, offset, length, name=None):
    """Per-sequence slice (reference sequence_slice_op)."""
    t = _as_lod(input)
    off = np.asarray(_t(offset).cpu()).reshape(-1)
    ln = np.asarray(_t(length).cpu()).reshape(-1)
    order = []
    new_lod = [0]
    for i in range(len(t.lod) - 1):
        start = t.lod[i] + int(off[i])
        order.extend(range(start, start + int(ln[i])))
        new_lod.append(len(order))
    v = _plain(t)
    return LoDTensor(v[_index(order, v)], new_lod)


def sequence_scatter(input, index, updates, name=None):
    """Scatter-add updates into input at per-sequence positions
    (reference sequence_scatter_op): `index` is a LoD tensor of positions
    into each corresponding row of input."""
    t = _plain(_t(input))
    idx = _as_lod(index)
    rows = _index(_seg_ids(idx.lod), t)
    cols = _index(np.asarray(_plain(idx).cpu()).reshape(-1), t)
    flat = rows * t.shape[1] + cols
    upd = _plain(_t(updates)).reshape(-1).to(t.dtype)
    return t.reshape(-1).index_add(0, flat, upd).reshape(t.shape)


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    """Sliding-window id enumeration per sequence (reference
    sequence_enumerate_op)."""
    t = _as_lod(input)
    vals = np.asarray(_plain(t).cpu()).reshape(-1)
    out = np.full((len(vals), win_size), pad_value,
                  vals.dtype if vals.dtype.kind == "i" else np.int64)
    for i in range(len(t.lod) - 1):
        for r in range(t.lod[i], t.lod[i + 1]):
            for w in range(win_size):
                if r + w < t.lod[i + 1]:
                    out[r, w] = vals[r + w]
    return LoDTensor(torch.as_tensor(out, device=t.device), t.lod)


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=True, padding_start=None, bias_attr=None,
                  param_attr=None, act=None, name=None):
    """Sequence (context-window) convolution (reference
    sequence_conv_op): each output row contracts a window of
    filter_size rows; windows never cross sequence boundaries
    (out-of-sequence taps read zeros)."""
    from .nn_build import _param

    t = _as_lod(input)
    v = _plain(t)
    d = int(v.shape[-1])
    weight = _param([filter_size * d, num_filters], param_attr, like=v)
    bias = (None if bias_attr is False else
            _param([num_filters], bias_attr, is_bias=True, like=v))
    start = (padding_start if padding_start is not None
             else -(filter_size // 2))
    total = t.lod[-1]
    gather = np.full((total, filter_size), -1, np.int64)
    for i in range(len(t.lod) - 1):
        lo, hi = t.lod[i], t.lod[i + 1]
        for r in range(lo, hi):
            for k in range(filter_size):
                srcr = r + start + k
                if lo <= srcr < hi:
                    gather[r, k] = srcr
    g = _index(np.clip(gather, 0, None), v)
    ok = torch.as_tensor(gather >= 0, device=v.device)
    win = torch.where(ok[..., None], v[g], 0.0)
    out = win.reshape(total, filter_size * d) @ weight
    if bias is not None:
        out = out + bias
    if act == "relu":
        out = torch.relu(out)
    elif act == "tanh":
        out = torch.tanh(out)
    return LoDTensor(out, t.lod)
