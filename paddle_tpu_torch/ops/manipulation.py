"""Shape / indexing / layout ops (counterpart of
paddle_tpu/ops/manipulation.py).

Plain functions on `torch.Tensor` under the reference's names,
signatures and return structures (lists where it returns lists, tuples
of (values, int64 indices) for `topk` / `kthvalue` / `mode`). The rules
the reference takes from jnp and XLA, which torch's own functions do
not promise, are kept explicitly:

- `sort` / `argsort` with `descending=True` are the flip of the stable
  ascending sort, so tied elements come out last index first;
- `topk` keeps the lower index of a tie (lax.top_k), with `largest=False`
  over the negated input: a stable descending sort, then the first k;
- `scatter`, `put_along_axis` (assign) and the other writes with
  repeated indices: the last writer wins. The targets are deduplicated
  (`_last_writer`) before one write, so the result does not depend on
  the order a CUDA scatter lands in; `scatter(overwrite=False)` zeroes
  the target rows, then adds every update;
- `unique` is np.unique's: sorted, with the first occurrence for
  `return_index`;
- `mode` takes the smallest of the most frequent values and the last
  index holding it, as the reference's host loop does, in tensor ops.

`reshape` also takes paddle's 0 (copy the input's dimension) beside −1;
`strided_slice` takes negative strides.
"""
import builtins

import numpy as np
import torch
import torch.nn.functional as tF

from ..core import dtype as dtype_mod
from ._helpers import cast as _amp
from ._helpers import defop, operand, tensor_of

_slice = builtins.slice


def _axes(axis):
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _ints(v):
    if isinstance(v, torch.Tensor):
        v = v.tolist()
    if isinstance(v, (int, np.integer)):
        return [int(v)]
    return [int(s.item()) if isinstance(s, torch.Tensor) else int(s)
            for s in v]


def _int(v):
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


@defop("cast")
def cast(x, dtype):
    return tensor_of(x).to(dtype_mod.convert_dtype(dtype))


@defop("reshape")
def reshape(x, shape, name=None):
    """-1 takes the rest; 0 keeps the input's dimension at that index."""
    (x,) = _amp("reshape", tensor_of(x))
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(_ints(shape))]
    return x.reshape(shape)


@defop("reshape_")
def reshape_(x, shape, name=None):
    """reshape written into `x` (its storage takes the new shape)."""
    x.data = reshape(x.detach(), shape)
    return x


@defop("flatten")
def flatten(x, start_axis=0, stop_axis=-1, name=None):
    (x,) = _amp("flatten", tensor_of(x))
    nd = x.ndim
    sa = start_axis % nd if nd else 0
    ea = stop_axis % nd if nd else 0
    return x.reshape(list(x.shape[:sa]) + [-1] + list(x.shape[ea + 1:]))


@defop("transpose")
def transpose(x, perm=None, name=None):
    (x,) = _amp("transpose", tensor_of(x))
    p = (tuple(reversed(range(x.ndim))) if perm is None
         else tuple(int(i) for i in perm))
    return x.permute(p)


@defop("moveaxis")
def moveaxis(x, source, destination, name=None):
    return torch.movedim(tensor_of(x), source, destination)


@defop("swapaxes")
def swapaxes(x, axis0, axis1, name=None):
    return torch.swapaxes(tensor_of(x), axis0, axis1)


@defop("squeeze")
def squeeze(x, axis=None, name=None):
    """Drop size-1 dims (of `axis` only, when given: others stay)."""
    (x,) = _amp("squeeze", tensor_of(x))
    if axis is None:
        return x.squeeze()
    ax = _axes(axis)
    ax = (ax,) if isinstance(ax, int) else ax
    ax = tuple(a for a in ax if x.shape[a] == 1)
    return x.squeeze(ax) if ax else x


@defop("unsqueeze")
def unsqueeze(x, axis, name=None):
    """New size-1 dims at `axis` (positions in the output)."""
    (x,) = _amp("unsqueeze", tensor_of(x))
    ax = _axes(axis)
    ax = (ax,) if isinstance(ax, int) else ax
    out_nd = x.ndim + len(ax)
    for a in sorted(a % out_nd for a in ax):
        x = x.unsqueeze(a)
    return x


@defop("concat")
def concat(x, axis=0, name=None):
    ts = _amp("concat", *(tensor_of(t) for t in x))
    return torch.cat(ts, dim=_int(axis))


@defop("stack")
def stack(x, axis=0, name=None):
    ts = _amp("stack", *(tensor_of(t) for t in x))
    return torch.stack(ts, dim=int(axis))


@defop("split")
def split(x, num_or_sections, axis=0, name=None):
    """A list of pieces: `num_or_sections` equal ones, or the given
    sizes (one −1 takes the rest)."""
    (x,) = _amp("split", tensor_of(x))
    axis = _int(axis)
    dim = x.shape[axis]
    if isinstance(num_or_sections, int):
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = _ints(num_or_sections)
        if -1 in sizes:
            known = builtins.sum(s for s in sizes if s >= 0)
            sizes = [s if s >= 0 else int(dim - known) for s in sizes]
    return list(torch.split(x, sizes, dim=axis))


@defop("chunk")
def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


@defop("unbind")
def unbind(x, axis=0, name=None):
    return list(torch.unbind(tensor_of(x), dim=int(axis)))


@defop("tile")
def tile(x, repeat_times, name=None):
    return torch.tile(tensor_of(x), tuple(_ints(repeat_times)))


@defop("expand")
def expand(x, shape, name=None):
    """Broadcast to `shape`; −1 keeps the input's dimension."""
    x = tensor_of(x)
    tgt = _ints(shape)
    off = len(tgt) - x.ndim
    tgt = [x.shape[i - off] if s == -1 else s for i, s in enumerate(tgt)]
    return x.expand(tgt)


@defop("broadcast_to")
def broadcast_to(x, shape, name=None):
    return expand(x, shape)


@defop("expand_as")
def expand_as(x, y, name=None):
    return expand(x, list(tensor_of(y).shape))


@defop("broadcast_tensors")
def broadcast_tensors(inputs, name=None):
    return list(torch.broadcast_tensors(*(tensor_of(t) for t in inputs)))


@defop("flip")
def flip(x, axis, name=None):
    ax = _axes(axis)
    return torch.flip(tensor_of(x), (ax,) if isinstance(ax, int) else ax)


@defop("rot90")
def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(tensor_of(x), k, tuple(axes))


@defop("roll")
def roll(x, shifts, axis=None, name=None):
    if isinstance(shifts, torch.Tensor):
        shifts = shifts.tolist()
    x = tensor_of(x)
    if axis is None:
        return torch.roll(x.reshape(-1), shifts).reshape(x.shape)
    return torch.roll(x, shifts, _axes(axis))


# ---- gather / scatter family ----
def _last_writer(lin, size):
    """Mask of the entries of the flat target indices `lin` that are
    the last occurrence of their index: the writes that survive when
    the last writer wins."""
    order = torch.arange(lin.numel(), device=lin.device)
    last = torch.full((size,), -1, dtype=torch.long, device=lin.device)
    last = last.scatter_reduce(0, lin, order, "amax")
    return last[lin] == order


@defop("gather")
def gather(x, index, axis=0, name=None):
    x, index = tensor_of(x), tensor_of(index)
    idx = index.reshape(-1) if index.ndim > 1 else index
    return torch.index_select(x, _int(axis), idx.long())


@defop("gather_nd")
def gather_nd(x, index, name=None):
    """x at the leading index.shape[-1] coordinates of each index row;
    the trailing dims come along."""
    x, index = tensor_of(x), tensor_of(index)
    return x[tuple(index.long().movedim(-1, 0))]


@defop("take_along_axis")
def take_along_axis(arr, indices, axis, name=None):
    return torch.take_along_dim(tensor_of(arr), tensor_of(indices).long(),
                                dim=int(axis))


def _along_axis_flat(a, i, axis):
    """Flat indices into `a` of every element of `i` along `axis` (the
    other dims by position)."""
    nd = a.ndim
    axis %= nd
    lin = torch.zeros(i.shape, dtype=torch.long, device=a.device)
    stride = 1
    for d in reversed(range(nd)):
        if d == axis:
            coord = i.long() % a.shape[d]
        else:
            shape = [1] * nd
            shape[d] = i.shape[d]
            coord = torch.arange(i.shape[d], device=a.device).reshape(shape)
        lin = lin + coord * stride
        stride *= a.shape[d]
    return lin


@defop("put_along_axis")
def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    """`values` written into `arr` at `indices` along `axis`; assign:
    the last writer of a repeated index wins; "add" / "mul" combine
    every write."""
    arr = tensor_of(arr)
    i = tensor_of(indices)
    v = operand(values, arr).to(arr.dtype).broadcast_to(i.shape)
    lin = _along_axis_flat(arr, i, axis).reshape(-1)
    v = v.reshape(-1)
    flat = arr.reshape(-1)
    if reduce == "assign":
        keep = _last_writer(lin, flat.numel())
        out = flat.index_put((lin[keep],), v[keep])
    elif reduce in ("add", "sum"):
        out = flat.index_add(0, lin, v)
    elif reduce in ("mul", "multiply"):
        out = flat.scatter_reduce(0, lin, v, "prod")
    else:
        raise ValueError(f"unknown reduce {reduce}")
    return out.reshape(arr.shape)


@defop("scatter")
def scatter(x, index, updates, overwrite=True, name=None):
    """Rows `index` of x replaced by `updates` (overwrite: the last
    writer of a repeated row wins) or, with overwrite=False, zeroed and
    then summed over every update aimed at them."""
    x, index, updates = tensor_of(x), tensor_of(index), tensor_of(updates)
    i = index.reshape(-1).long() % x.shape[0]
    updates = updates.to(x.dtype)
    if overwrite:
        keep = _last_writer(i, x.shape[0])
        return x.index_put((i[keep],), updates[keep])
    base = x.index_put((i,), torch.zeros((), dtype=x.dtype,
                                         device=x.device))
    return base.index_add(0, i, updates)


@defop("scatter_nd_add")
def scatter_nd_add(x, index, updates, name=None):
    x, index, updates = tensor_of(x), tensor_of(index), tensor_of(updates)
    return x.index_put(tuple(index.long().movedim(-1, 0)),
                       updates.to(x.dtype), accumulate=True)


@defop("scatter_nd")
def scatter_nd(index, updates, shape, name=None):
    index, updates = tensor_of(index), tensor_of(updates)
    base = torch.zeros(tuple(_ints(shape)), dtype=updates.dtype,
                       device=updates.device)
    return scatter_nd_add(base, index, updates)


@defop("index_select")
def index_select(x, index, axis=0, name=None):
    return torch.index_select(tensor_of(x), int(axis),
                              tensor_of(index).long())


@defop("index_sample")
def index_sample(x, index):
    return torch.take_along_dim(tensor_of(x), tensor_of(index).long(),
                                dim=1)


@defop("masked_select")
def masked_select(x, mask, name=None):
    return tensor_of(x)[tensor_of(mask).bool()]


@defop("masked_fill")
def masked_fill(x, mask, value, name=None):
    x = tensor_of(x)
    return torch.where(tensor_of(mask).bool(), operand(value, x), x)


@defop("where")
def where(condition, x=None, y=None, name=None):
    condition = tensor_of(condition)
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    if isinstance(x, torch.Tensor):
        y = operand(y, x)
    else:
        y = tensor_of(y, like=condition)
        x = operand(x, y)
    x, y = _amp("where", x, y)
    return torch.where(condition.bool(), x, y)


@defop("nonzero")
def nonzero(x, as_tuple=False, name=None):
    x = tensor_of(x)
    nz = torch.nonzero(x)
    if as_tuple:
        return tuple(nz.unbind(1))
    return nz


# ---- sort / search ----
@defop("sort")
def sort(x, axis=-1, descending=False, name=None):
    """Stable ascending sort; descending is its flip."""
    x = tensor_of(x)
    s = torch.sort(x, dim=axis, stable=True).values
    return torch.flip(s, (axis,)) if descending else s


@defop("argsort")
def argsort(x, axis=-1, descending=False, name=None):
    """int64 indices of the stable ascending sort; descending is their
    flip (ties: last index first)."""
    x = tensor_of(x)
    i = torch.argsort(x, dim=axis, stable=True)
    return torch.flip(i, (axis,)) if descending else i


@defop("topk")
def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    """(values, int64 indices) of the k largest (smallest) along axis,
    in descending (ascending) order; a tie keeps the lower index."""
    x = tensor_of(x)
    k = _int(k)
    ax = axis % x.ndim
    moved = torch.movedim(x, ax, -1)
    key = moved if largest else -moved
    idx = torch.argsort(key, dim=-1, descending=True, stable=True)[..., :k]
    vals = torch.take_along_dim(moved, idx, dim=-1)
    return torch.movedim(vals, -1, ax), torch.movedim(idx, -1, ax)


@defop("kthvalue")
def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    x = tensor_of(x)
    s, i = torch.sort(x, dim=axis, stable=True)
    v = s.select(axis, k - 1)
    ix = i.select(axis, k - 1)
    if keepdim:
        v, ix = v.unsqueeze(axis), ix.unsqueeze(axis)
    return v, ix


@defop("mode")
def mode(x, axis=-1, keepdim=False, name=None):
    """(the most frequent value, the last index holding it) along axis;
    of equally frequent values the smallest."""
    x = tensor_of(x)
    moved = torch.movedim(x, axis, -1)
    shp = list(moved.shape[:-1])
    flat = moved.reshape(-1, moved.shape[-1])
    n = flat.shape[-1]
    s = torch.sort(flat, dim=-1, stable=True).values
    start = torch.ones_like(s, dtype=torch.bool)
    start[:, 1:] = s[:, 1:] != s[:, :-1]
    run = torch.cumsum(start.long(), dim=-1) - 1
    counts = torch.zeros_like(run).scatter_add_(1, run, torch.ones_like(run))
    best = counts.argmax(dim=-1, keepdim=True)       # first: smallest value
    first_pos = torch.where(start, torch.arange(n, device=x.device), n)
    pos = torch.take_along_dim(
        torch.sort(first_pos, dim=-1).values, best, dim=-1)
    vals = torch.take_along_dim(s, pos, dim=-1)
    hit = flat == vals
    idx = torch.where(hit, torch.arange(n, device=x.device), -1).amax(-1)
    out_v, out_i = vals[:, 0].reshape(shp), idx.reshape(shp)
    if keepdim:
        out_v, out_i = out_v.unsqueeze(axis), out_i.unsqueeze(axis)
    return out_v, out_i


@defop("searchsorted")
def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    ss, v = tensor_of(sorted_sequence), tensor_of(values)
    return torch.searchsorted(ss, v, out_int32=out_int32, right=right)


@defop("bucketize")
def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32, right)


@defop("unique")
def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """np.unique's: the sorted unique values (rows along `axis`), then
    as asked the index of each one's first occurrence, the inverse and
    the counts. NaNs sort last and count as one value, as in numpy."""
    x = tensor_of(x)
    src = x.reshape(-1) if axis is None else x
    dim = 0 if axis is None else int(axis)
    nan = (torch.isnan(src) if axis is None and src.is_floating_point()
           else None)
    if nan is not None and bool(nan.any()):
        # numpy sorts NaN last and folds every NaN into one value
        u, inv_k, cnt = torch.unique(src[~nan], sorted=True,
                                     return_inverse=True, return_counts=True)
        inv = torch.full(src.shape, u.numel(), dtype=inv_k.dtype,
                         device=x.device)
        inv[~nan] = inv_k
        u = torch.cat([u, src.new_full((1,), float("nan"))])
        cnt = torch.cat([cnt, nan.sum().reshape(1).to(cnt.dtype)])
    else:
        u, inv, cnt = torch.unique(src, sorted=True, return_inverse=True,
                                   return_counts=True, dim=dim)
    out = [u]
    if return_index:
        n = src.shape[dim]
        first = torch.full((u.shape[dim],), n, dtype=torch.long,
                           device=x.device)
        out.append(first.scatter_reduce(
            0, inv, torch.arange(n, device=x.device), "amin"))
    if return_inverse:
        out.append(inv.reshape(x.shape) if axis is None else inv)
    if return_counts:
        out.append(cnt)
    return out[0] if len(out) == 1 else tuple(out)


@defop("unique_consecutive")
def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, name=None):
    if axis is not None:
        raise NotImplementedError
    flat = tensor_of(x).reshape(-1)
    u, inv, cnt = torch.unique_consecutive(flat, return_inverse=True,
                                           return_counts=True)
    out = [u]
    if return_inverse:
        out.append(inv)
    if return_counts:
        out.append(cnt)
    return out[0] if len(out) == 1 else tuple(out)


# ---- padding ----
def _pad_index(n, lo, hi, mode, device):
    """Source index of each padded position along one dim (numpy's
    reflect / edge / wrap)."""
    j = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return j.clamp(0, n - 1)
    if mode == "wrap":
        return j % n
    period = 2 * (n - 1)
    j = j.abs() % period if period else j * 0
    return torch.where(j >= n, period - j, j)


@defop("pad")
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """pad: 2·ndim numbers (dim by dim, low then high) or 2·k for the k
    trailing spatial dims (paddle's order: the last dim's pair first),
    NC* or N*C by `data_format`."""
    (x,) = _amp("pad", tensor_of(x))
    pad = _ints(pad)
    nd = x.ndim
    if len(pad) == 2 * nd:
        pairs = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        k = len(pad) // 2
        spatial = [(pad[2 * i], pad[2 * i + 1]) for i in range(k)]
        if data_format.upper().startswith("NC"):
            pairs = [(0, 0)] * (nd - k) + spatial[::-1]
        else:
            pairs = [(0, 0)] + spatial[::-1] + [(0, 0)]
    tmode = {"constant": "constant", "reflect": "reflect",
             "replicate": "edge", "circular": "wrap"}[mode]
    if tmode == "constant":
        flat = [p for lo_hi in reversed(pairs) for p in lo_hi]
        return tF.pad(x, flat, value=value)
    for d, (lo, hi) in enumerate(pairs):
        if lo or hi:
            x = torch.index_select(
                x, d, _pad_index(x.shape[d], lo, hi, tmode, x.device))
    return x


@defop("repeat_interleave")
def repeat_interleave(x, repeats, axis=None, name=None):
    x = tensor_of(x)
    if isinstance(repeats, torch.Tensor):
        repeats = repeats.to(x.device)
    return torch.repeat_interleave(x, repeats, dim=axis)


@defop("tensordot")
def tensordot(x, y, axes=2, name=None):
    x, y = _amp("tensordot", tensor_of(x), tensor_of(y))
    return torch.tensordot(x, y, dims=axes)


def _index_along(x, ax, s, e, st):
    """x[..., s:e:st, ...] on axis `ax`, numpy's rules (negative steps
    included)."""
    n = x.shape[ax]
    start, stop, step = _slice(s, e, st).indices(n)
    if step > 0:
        idx = [_slice(None)] * x.ndim
        idx[ax] = _slice(start, stop, step)
        return x[tuple(idx)]
    rows = torch.arange(start, stop, step, device=x.device)
    return torch.index_select(x, ax, rows)


@defop("slice")
def slice(input, axes, starts, ends):
    (x,) = _amp("slice", tensor_of(input))
    for ax, s, e in zip(axes, starts, ends):
        x = _index_along(x, int(ax), _int(s), _int(e), 1)
    return x


@defop("strided_slice")
def strided_slice(x, axes, starts, ends, strides, name=None):
    (x,) = _amp("strided_slice", tensor_of(x))
    for ax, s, e, st in zip(axes, starts, ends, strides):
        x = _index_along(x, int(ax), _int(s), _int(e), _int(st))
    return x
