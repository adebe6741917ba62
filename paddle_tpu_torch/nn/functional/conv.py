"""Convolutions (counterpart of paddle_tpu/nn/functional/conv.py).

The reference lowers every convolution to `lax.conv_general_dilated`;
the port calls `torch.nn.functional.conv{1,2,3}d` and their transposes
(cuDNN on the card). What the port adds around them is the reference's
argument handling:

- paddle's padding forms (`_norm_padding`): an int, one int a spatial
  dim, a (lo, hi) pair a dim as a flat list or as pairs, a full
  per-dimension spec with the batch and channel entries, and "SAME" /
  "VALID". "SAME" pads as XLA does: out = ceil(in / stride), and the
  total padding's odd unit goes on the high side. torch's
  `padding="same"` refuses stride > 1 and an asymmetric pair has no
  torch argument, so those pad explicitly with `F.pad`;
- NCHW and NHWC (NCL / NLC, NCDHW / NDHWC): the weight stays
  [out, in/groups, k…] (OIHW) in both, and a channel-last input is moved
  to channel-first around the call;
- AMP: `conv{n}d` and `conv{n}d_transpose` are on the white list. The
  bias add is a separate op (`conv{n}d_bias`), on no list: under O1 a
  bf16 conv output plus an f32 bias gives f32, as in jnp.

A transpose takes [in, out/groups, k…] and paddle's `output_padding`;
like the reference it refuses string padding and ignores
`output_size`.
"""
import torch.nn.functional as tF

from ... import amp

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

_CHANNEL_LAST = ("NHWC", "NLC", "NWC", "NDHWC")
_CONV = {1: tF.conv1d, 2: tF.conv2d, 3: tF.conv3d}
_CONV_T = {1: tF.conv_transpose1d, 2: tF.conv_transpose2d,
           3: tF.conv_transpose3d}


def _norm_tuple(v, n, name):
    if isinstance(v, int):
        return (v,) * n
    v = tuple(int(x) for x in v)
    if len(v) == 1:
        return v * n
    if len(v) != n:
        raise ValueError(f"{name} must have {n} elements, got {v}")
    return v


def _norm_padding(padding, n, channel_last=False):
    """paddle padding → "SAME" / "VALID" or n (lo, hi) pairs."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * n and all(isinstance(p, int) for p in padding):
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    if all(isinstance(p, (list, tuple)) for p in padding):
        pairs = [tuple(p) for p in padding]
        if len(pairs) == n + 2:
            # a full per-dimension spec: drop the batch and channel
            # entries at their layout's positions
            pairs = pairs[1:-1] if channel_last else pairs[2:]
        return pairs
    raise ValueError(f"bad padding spec: {padding}")


def same_pads(sizes, windows, strides):
    """XLA's "SAME" pairs (`lax.padtype_to_pads`): out = ceil(in /
    stride), total = max((out - 1)·stride + window − in, 0), the odd unit
    on the high side. `windows` are the effective (dilated) sizes."""
    pads = []
    for size, w, s in zip(sizes, windows, strides):
        out = -(-size // s)
        total = max((out - 1) * s + w - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _pairs(pad, x, kernel, stride, dilation):
    """The (lo, hi) pairs of a channel-first input `x`."""
    n = len(kernel)
    if pad == "VALID":
        return [(0, 0)] * n
    if pad == "SAME":
        eff = [(k - 1) * d + 1 for k, d in zip(kernel, dilation)]
        return same_pads(x.shape[2:], eff, stride)
    if isinstance(pad, str):
        raise ValueError(f"unknown padding {pad!r}")
    return [tuple(int(v) for v in p) for p in pad]


def _flat_pad(pairs):
    """F.pad's argument: the last dimension's pair first."""
    out = []
    for lo, hi in reversed(pairs):
        out += [lo, hi]
    return out


def _add_bias(out, bias, n, channel_last, op):
    out, bias = amp.cast_inputs_for(op, (out, bias))
    shape = (1,) * (n + 1) + (-1,) if channel_last else (1, -1) + (1,) * n
    return out + bias.reshape(shape)


def _conv(x, weight, bias, stride, padding, dilation, groups, n,
          data_format):
    channel_last = data_format in _CHANNEL_LAST
    stride = _norm_tuple(stride, n, "stride")
    dilation = _norm_tuple(dilation, n, "dilation")
    pad = _norm_padding(padding, n, channel_last)
    x, weight = amp.cast_inputs_for(f"conv{n}d", (x, weight))
    if channel_last:
        x = x.movedim(-1, 1)
    pairs = _pairs(pad, x, weight.shape[2:], stride, dilation)
    if all(lo == hi for lo, hi in pairs):
        out = _CONV[n](x, weight, None, stride, tuple(lo for lo, _ in pairs),
                       dilation, groups)
    else:
        out = _CONV[n](tF.pad(x, _flat_pad(pairs)), weight, None, stride,
                       0, dilation, groups)
    if channel_last:
        out = out.movedim(1, -1)
    if bias is not None:
        out = _add_bias(out, bias, n, channel_last, f"conv{n}d_bias")
    return out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    df = "NWC" if data_format in ("NLC", "NWC") else "NCW"
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1, df)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format)


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, n, data_format):
    """paddle's conv transpose (the input gradient of a conv). Output
    length (in − 1)·stride + (k − 1)·dilation + 1 − lo − hi +
    output_padding; torch's padding and output_padding give it when
    lo == hi and output_padding < max(stride, dilation), else the full
    output is cut (and zero-extended past hi) with `F.pad`."""
    channel_last = data_format in _CHANNEL_LAST
    stride = _norm_tuple(stride, n, "stride")
    dilation = _norm_tuple(dilation, n, "dilation")
    opad = _norm_tuple(output_padding, n, "output_padding")
    pad = _norm_padding(padding, n, channel_last)
    if isinstance(pad, str):
        raise ValueError("SAME/VALID strings unsupported for conv_transpose")
    x, weight = amp.cast_inputs_for(f"conv{n}d_transpose", (x, weight))
    if channel_last:
        x = x.movedim(-1, 1)
    fn = _CONV_T[n]
    if all(lo == hi and o < max(s, d) for (lo, hi), o, s, d
           in zip(pad, opad, stride, dilation)):
        out = fn(x, weight, None, stride, tuple(lo for lo, _ in pad), opad,
                 groups, dilation)
    else:
        out = fn(x, weight, None, stride, 0, 0, groups, dilation)
        out = tF.pad(out, _flat_pad([(-lo, o - hi) for (lo, hi), o
                                     in zip(pad, opad)]))
    if channel_last:
        out = out.movedim(1, -1)
    if bias is not None:
        out = _add_bias(out, bias, n, channel_last,
                        f"conv{n}d_transpose_bias")
    return out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCL", name=None):
    df = "NWC" if data_format in ("NLC", "NWC") else "NCW"
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 1, df)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 2, data_format)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCDHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 3, data_format)
