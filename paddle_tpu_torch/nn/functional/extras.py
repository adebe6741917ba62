"""Functional extras (counterpart of paddle_tpu/nn/functional/extras.py):
length masks, the video channel shift, the beam-search backtrace,
zero padding, PartialFC class-centre sampling, CSR block-sparse
attention, and the in-place activations.

`class_center_sample` keeps every positive class and draws the
negatives with numpy from a seed taken from the port's generators; the
draws differ from the reference's (jax's key stream), the rule does
not.
"""
import numpy as np
import torch
import torch.nn.functional as tF

from ... import amp
from ...core import rng
from ...core.dtype import convert_dtype

__all__ = [
    "sequence_mask", "temporal_shift", "gather_tree", "zeropad2d",
    "class_center_sample", "sparse_attention", "relu_", "elu_", "tanh_",
    "softmax_",
]


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """[..., maxlen]: 1 where the position is below the length."""
    if maxlen is None:
        maxlen = int(x.max())
    pos = torch.arange(int(maxlen), device=x.device)
    return (pos < x[..., None]).to(convert_dtype(dtype))


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """TSM: the first shift_ratio of the channels move one step back in
    time, the next shift_ratio one step forward (zeros enter), the rest
    stay. x is [N·T, C, H, W] (or NHWC)."""
    (x,) = amp.cast_inputs_for("temporal_shift", (x,))
    v = x.movedim(-1, 1) if data_format == "NHWC" else x
    nt, c = v.shape[:2]
    v5 = v.reshape((nt // seg_num, seg_num) + tuple(v.shape[1:]))
    c1, c2 = int(c * shift_ratio), int(c * 2 * shift_ratio)
    back = torch.cat([v5[:, 1:, :c1], torch.zeros_like(v5[:, :1, :c1])], 1)
    fwd = torch.cat([torch.zeros_like(v5[:, :1, c1:c2]), v5[:, :-1, c1:c2]],
                    1)
    out = torch.cat([back, fwd, v5[:, :, c2:]], 2).reshape(v.shape)
    return out.movedim(1, -1) if data_format == "NHWC" else out


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


def zeropad2d(x, padding, data_format="NCHW", name=None):
    """Zero-pad H and W by [left, right, top, bottom]."""
    (x,) = amp.cast_inputs_for("zeropad2d", (x,))
    left, right, top, bottom = (int(p) for p in padding)
    if data_format == "NHWC":
        return tF.pad(x, (0, 0, left, right, top, bottom))
    return tF.pad(x, (left, right, top, bottom))


def class_center_sample(label, num_classes, num_samples, group=None):
    """Keep every positive class, add uniformly drawn negatives up to
    num_samples (sorted), and map the labels into the sampled index
    space. Returns (remapped labels, sampled class ids)."""
    lbl = label.reshape(-1).long().cpu().numpy()
    pos = np.unique(lbl)
    if len(pos) >= num_samples:
        sampled = pos
    else:
        gen = rng.current_generator() or rng.next_generator("cpu")
        seed = int(torch.randint(0, 2**31 - 1, (), generator=gen))
        neg = np.setdiff1d(np.arange(num_classes, dtype=np.int64), pos,
                           assume_unique=True)
        extra = np.random.default_rng(seed).choice(
            neg, size=num_samples - len(pos), replace=False)
        sampled = np.sort(np.concatenate([pos, extra]))
    remap = np.full(num_classes, -1, np.int64)
    remap[sampled] = np.arange(len(sampled))
    return (torch.from_numpy(remap[lbl].reshape(tuple(label.shape))).to(
                label.device),
            torch.from_numpy(sampled).to(label.device))


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Attention over the (row, column) pairs a CSR pattern allows, as a
    dense mask. q / k / v [batch, heads, seq, head_dim]; offset [batch,
    heads, seq + 1]; columns [batch, heads, nnz]."""
    q, k, v = amp.cast_inputs_for("sparse_attention", (query, key, value))
    b, h, m, d = q.shape
    off = sparse_csr_offset.long()
    cols = sparse_csr_columns.long()
    nnz = cols.shape[-1]
    ar = torch.arange(nnz, device=q.device).expand(b, h, nnz).contiguous()
    rows = torch.searchsorted(off.contiguous(), ar, right=True) - 1
    # entries past the last offset (padding) select nothing
    live = (rows < m) & (cols < m)
    bi = torch.arange(b, device=q.device)[:, None, None].expand_as(rows)
    hi = torch.arange(h, device=q.device)[None, :, None].expand_as(rows)
    mask = torch.zeros((b, h, m, m), dtype=torch.bool, device=q.device)
    mask[bi[live], hi[live], rows[live], cols[live]] = True
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / torch.sqrt(
        torch.tensor(d, dtype=q.dtype, device=q.device))
    scores = torch.where(mask, scores, torch.tensor(
        -1e30, dtype=scores.dtype, device=q.device))
    w = torch.softmax(scores.float(), dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", w, v)


def relu_(x, name=None):
    return torch.relu_(x)


def elu_(x, alpha=1.0, name=None):
    return tF.elu_(x, alpha)


def tanh_(x, name=None):
    return x.tanh_()


def softmax_(x, axis=-1, dtype=None, name=None):
    return x.copy_(torch.softmax(x, dim=axis))

