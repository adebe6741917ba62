"""static.nn layer builders (counterpart of paddle_tpu/static/nn_build.py;
reference python/paddle/static/nn/ — fc, conv2d, batch_norm, embedding,
nce, ... over LayerHelper).

Each builder creates the matching eager layer ONCE (owning its
parameters, on the current default device: `static.Executor` runs its
stages under its place's device) and applies it. Ops take and return
torch tensors.
"""
import contextlib

import numpy as np
import torch
import torch.nn.functional as TF
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree

__all__ = [
    "fc", "conv2d", "conv2d_transpose", "conv3d", "conv3d_transpose",
    "batch_norm", "instance_norm", "layer_norm", "group_norm", "data_norm",
    "embedding", "sparse_embedding", "prelu", "spectral_norm",
    "deform_conv2d", "bilinear_tensor_product", "nce", "row_conv",
    "crf_decoding", "py_func", "create_parameter", "multi_box_head",
    "continuous_value_model", "StaticRNN",
]


def _t(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def _dev(x):
    return x.device if isinstance(x, torch.Tensor) else None


def _act(out, act):
    if act is None:
        return out
    from ..nn import functional as F

    return getattr(F, act)(out)


def _param(shape, attr, is_bias=False, like=None):
    from ..nn.layer.layers import create_parameter as _cp

    return _cp(shape, attr, dtype=None if like is None else like.dtype,
               is_bias=is_bias, device=None if like is None else like.device)


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    """(reference static/nn/common.py fc)."""
    from .. import nn

    xs = x if isinstance(x, (list, tuple)) else [x]
    outs = []
    for xi in xs:
        xi = _t(xi)
        lead = list(xi.shape[:num_flatten_dims])
        flat_in = int(np.prod(xi.shape[num_flatten_dims:]))
        layer = nn.Linear(flat_in, size, weight_attr=weight_attr,
                          bias_attr=bias_attr, device=xi.device)
        outs.append(layer(xi.reshape(lead + [flat_in])))
    out = outs[0]
    for o in outs[1:]:
        out = out + o
    return _act(out, activation)


def conv2d(input, num_filters, filter_size, stride=1, padding=0,
           dilation=1, groups=1, param_attr=None, bias_attr=None,
           use_cudnn=True, act=None, name=None, data_format="NCHW"):
    from .. import nn

    in_c = input.shape[1 if data_format == "NCHW" else -1]
    layer = nn.Conv2D(in_c, num_filters, filter_size, stride, padding,
                      dilation, groups, weight_attr=param_attr,
                      bias_attr=bias_attr, data_format=data_format)
    return _act(layer.to(_dev(input))(input), act)


def conv3d(input, num_filters, filter_size, stride=1, padding=0,
           dilation=1, groups=1, param_attr=None, bias_attr=None,
           use_cudnn=True, act=None, name=None, data_format="NCDHW"):
    from .. import nn

    in_c = input.shape[1 if data_format == "NCDHW" else -1]
    layer = nn.Conv3D(in_c, num_filters, filter_size, stride, padding,
                      dilation, groups, weight_attr=param_attr,
                      bias_attr=bias_attr, data_format=data_format)
    return _act(layer.to(_dev(input))(input), act)


def _transpose_kernel_from_output(input, output_size, stride, padding,
                                  dilation, n, data_format):
    """Derive filter_size from the requested output size (reference
    conv2d_transpose supports either one): k = out - (in-1)·s + 2·p."""
    spatial = (input.shape[2:2 + n] if data_format.startswith("NC")
               else input.shape[1:1 + n])
    out = ([output_size] * n if isinstance(output_size, int)
           else list(output_size))
    s = [stride] * n if isinstance(stride, int) else list(stride)
    p = [padding] * n if isinstance(padding, int) else list(padding)
    d = [dilation] * n if isinstance(dilation, int) else list(dilation)
    k = []
    for i in range(n):
        eff = out[i] - (int(spatial[i]) - 1) * s[i] + 2 * p[i]
        if eff < 1 or (eff - 1) % d[i] != 0:
            raise ValueError(
                f"output_size {out[i]} unreachable from input "
                f"{spatial[i]} with stride {s[i]} padding {p[i]}")
        k.append((eff - 1) // d[i] + 1)
    return k


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None, data_format="NCHW"):
    from .. import nn

    if filter_size is None:
        if output_size is None:
            raise ValueError("pass filter_size or output_size")
        filter_size = _transpose_kernel_from_output(
            input, output_size, stride, padding, dilation, 2, data_format)
    in_c = input.shape[1 if data_format == "NCHW" else -1]
    layer = nn.Conv2DTranspose(in_c, num_filters, filter_size, stride,
                               padding, weight_attr=param_attr,
                               bias_attr=bias_attr, dilation=dilation,
                               groups=groups, data_format=data_format)
    return _act(layer.to(_dev(input))(input), act)


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None, data_format="NCDHW"):
    from .. import nn

    if filter_size is None:
        if output_size is None:
            raise ValueError("pass filter_size or output_size")
        filter_size = _transpose_kernel_from_output(
            input, output_size, stride, padding, dilation, 3, data_format)
    in_c = input.shape[1 if data_format == "NCDHW" else -1]
    layer = nn.Conv3DTranspose(in_c, num_filters, filter_size, stride,
                               padding, weight_attr=param_attr,
                               bias_attr=bias_attr, dilation=dilation,
                               groups=groups, data_format=data_format)
    return _act(layer.to(_dev(input))(input), act)


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None, do_model_average_for_mean_and_var=True,
               use_global_stats=False):
    from .. import nn

    c = input.shape[1 if data_layout == "NCHW" else -1]
    layer = nn.BatchNorm(c, momentum=momentum, epsilon=epsilon,
                         param_attr=param_attr, bias_attr=bias_attr,
                         data_layout=data_layout).to(_dev(input))
    if is_test or use_global_stats:
        layer.eval()
    return _act(layer(input), act)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    from .. import nn

    layer = nn.InstanceNorm2D(input.shape[1], epsilon=epsilon,
                              weight_attr=param_attr, bias_attr=bias_attr)
    return layer.to(_dev(input))(input)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    from .. import nn

    shape = list(input.shape[begin_norm_axis:])
    layer = nn.LayerNorm(shape, epsilon=epsilon,
                         weight_attr=param_attr if scale else False,
                         bias_attr=bias_attr if shift else False)
    return _act(layer.to(_dev(input))(input), act)


def group_norm(input, groups, epsilon=1e-5, param_attr=None,
               bias_attr=None, act=None, data_layout="NCHW", name=None):
    from .. import nn

    layer = nn.GroupNorm(groups, input.shape[1], epsilon=epsilon,
                         weight_attr=param_attr, bias_attr=bias_attr)
    return _act(layer.to(_dev(input))(input), act)


def data_norm(input, act=None, epsilon=1e-5, param_attr=None,
              data_layout="NCHW", in_place=False, name=None,
              moving_mean_name=None, moving_variance_name=None,
              do_model_average_for_mean_and_var=True, slot_dim=-1,
              sync_stats=False, summary_decay_rate=0.9999999,
              enable_scale_and_shift=False):
    """Batch-stat normalization without learned affine by default
    (reference static/nn/common.py data_norm — CTR models)."""
    v = _t(input)
    mean = v.mean(0, keepdim=True)
    var = v.var(0, keepdim=True, unbiased=False)
    return _act((v - mean) / torch.sqrt(var + epsilon), act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    from .. import nn

    layer = nn.Embedding(size[0], size[1], padding_idx=padding_idx,
                         weight_attr=param_attr)
    return layer.to(_dev(input))(input)


def sparse_embedding(input, size, padding_idx=None, is_test=False,
                     entry=None, table_class="MemorySparseTable",
                     param_attr=None, dtype="float32", slot=None):
    """PS-backed sparse embedding (reference static/nn/common.py
    sparse_embedding): the dense embedding, no PS runtime here."""
    return embedding(input, size, is_sparse=True, padding_idx=padding_idx,
                     param_attr=param_attr, dtype=dtype)


def prelu(x, mode, param_attr=None, data_format="NCHW", name=None):
    from .. import nn

    if mode == "all":
        num = 1
    elif mode == "channel":
        num = x.shape[1 if data_format == "NCHW" else -1]
    else:  # element
        num = int(np.prod(x.shape[1:]))
    layer = nn.PReLU(num_parameters=num, weight_attr=param_attr,
                     data_format=data_format)
    return layer.to(_dev(x))(x)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """Spectral normalization of a weight tensor (reference
    static/nn/common.py spectral_norm): weight / sigma_max, sigma
    estimated by power iteration."""
    wv = _t(weight)
    mat = torch.movedim(wv, dim, 0).reshape(wv.shape[dim], -1)
    u = torch.ones((mat.shape[0],), dtype=wv.dtype, device=wv.device) \
        / np.sqrt(mat.shape[0])
    for _ in range(max(power_iters, 1)):
        v = mat.T @ u
        v = v / torch.clamp(torch.linalg.vector_norm(v), min=eps)
        u = mat @ v
        u = u / torch.clamp(torch.linalg.vector_norm(u), min=eps)
    sigma = u @ mat @ v
    return wv / torch.clamp(sigma, min=eps)


def deform_conv2d(x, offset, mask, num_filters, filter_size, stride=1,
                  padding=0, dilation=1, groups=1, deformable_groups=1,
                  im2col_step=1, weight_attr=None, bias_attr=None,
                  name=None):
    from ..vision.ops import DeformConv2D

    layer = DeformConv2D(x.shape[1], num_filters, filter_size, stride,
                         padding, dilation, deformable_groups, groups,
                         weight_attr, bias_attr)
    return layer.to(_dev(x))(x, offset, mask)


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    from .. import nn

    layer = nn.Bilinear(x.shape[-1], y.shape[-1], size,
                        weight_attr=param_attr, bias_attr=bias_attr)
    return _act(layer.to(_dev(x))(x, y), act)


def _nce_negatives(n, k, num_classes, device):
    """[n, k] noise classes, uniform, from the port's generators."""
    from ..core import rng

    gen = rng.current_generator() or rng.next_generator(device)
    return torch.randint(0, num_classes, (n, k), generator=gen,
                         device=gen.device).to(device)


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=5, name=None,
        sampler="uniform", custom_dist=None, seed=0, is_sparse=False):
    """Noise-contrastive estimation loss (reference static/nn/common.py
    nce → nce_op): logistic discrimination of the true class against
    uniformly sampled noise classes; [n, 1]."""
    x = _t(input)
    lbl = _t(label).reshape(-1).long()
    d = x.shape[-1]
    w = _param([num_total_classes, d], param_attr, like=x)
    b = (None if bias_attr is False else
         _param([num_total_classes], bias_attr, is_bias=True, like=x))
    neg = _nce_negatives(x.shape[0], num_neg_samples, num_total_classes,
                         x.device)
    pos_logit = (x * w[lbl]).sum(-1)
    neg_logit = torch.einsum("nd,nkd->nk", x, w[neg])
    if b is not None:
        pos_logit = pos_logit + b[lbl]
        neg_logit = neg_logit + b[neg]
    loss = TF.softplus(-pos_logit) + TF.softplus(neg_logit).sum(-1)
    return loss[:, None]


def row_conv(input, future_context_size, param_attr=None, act=None):
    """Lookahead row convolution (reference static/nn/common.py row_conv
    → row_conv_op, DeepSpeech2): out[t] = sum_k w[k] * x[t+k]."""
    v = _t(input)
    k = future_context_size + 1
    w = _param([k, v.shape[-1]], param_attr, like=v)
    squeeze = v.dim() == 2   # LoD flat [T, d]: one batch
    if squeeze:
        v = v[None]
    out = torch.zeros_like(v)
    for i in range(k):
        out = out + TF.pad(v[:, i:], (0, 0, 0, i)) * w[i]
    return _act(out[0] if squeeze else out, act)


def _viterbi(pots, trans, lens, include_bos_eos_tag=True):
    """(scores [B], paths [B, L]): the reference's text.viterbi_decode
    (viterbi_decode_kernel.cc: transition row -1 = START, -2 = STOP)."""
    B, L, C = pots.shape
    if include_bos_eos_tag:
        start, stop = trans[-1], trans[-2]
    else:
        start = stop = torch.zeros((C,), dtype=pots.dtype,
                                   device=pots.device)
    alpha = pots[:, 0] + start[None, :]
    backptrs = []
    for t in range(1, L):
        scores = alpha[:, :, None] + trans[None, :, :]
        best_prev = torch.argmax(scores, dim=1)
        best = scores.amax(dim=1) + pots[:, t]
        alpha = torch.where((t < lens)[:, None], best, alpha)
        backptrs.append(best_prev)
    final = alpha + stop[None, :]
    scores = final.amax(dim=1)
    tag = torch.argmax(final, dim=1)
    path = [tag]
    for t in range(L - 2, -1, -1):
        prev = torch.gather(backptrs[t], 1, tag[:, None])[:, 0]
        tag = torch.where(t + 1 < lens, prev, tag)
        path.append(tag)
    return scores, torch.stack(path[::-1], dim=1)


def crf_decoding(input, param_attr=None, label=None, length=None,
                 transition=None):
    """Viterbi decode with CRF transitions (reference static/nn/common.py
    crf_decoding → crf_decoding_op): the best path [B, L]."""
    x = _t(input)
    if transition is None:
        raise ValueError(
            "pass transition= (the linear_chain_crf parameter); the "
            "static-graph param_attr lookup has no scope here")
    if x.dim() == 2:
        x = x[None]
    if length is None:
        length = torch.full((x.shape[0],), x.shape[1], dtype=torch.int64,
                            device=x.device)
    _, path = _viterbi(x, _t(transition).to(x.device),
                       _t(length).to(x.device).reshape(-1))
    return path


def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None):
    """Host-python op (reference static/nn/common.py py_func → py_func_op):
    runs `func` on host arrays, forward only."""
    xs = x if isinstance(x, (list, tuple)) else [x]
    vals = [np.asarray(_t(t).detach().cpu()) for t in xs]
    res = func(*vals)
    dev = _dev(xs[0]) if xs else None
    if isinstance(res, (list, tuple)):
        return [torch.as_tensor(np.asarray(r), device=dev) for r in res]
    return torch.as_tensor(np.asarray(res), device=dev)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    from ..ops.api_misc import create_parameter as _cp

    return _cp(shape, dtype, name=name, attr=attr, is_bias=is_bias,
               default_initializer=default_initializer)


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """SSD detection head (reference static/nn/common.py multi_box_head):
    per-feature-map box / score convs + prior boxes."""
    from .. import nn

    n_inputs = len(inputs)
    if min_sizes is None:
        min_ratio, max_ratio = int(min_ratio), int(max_ratio)
        step = int((max_ratio - min_ratio) / max(n_inputs - 2, 1))
        min_sizes, max_sizes = [], []
        for ratio in range(min_ratio, max_ratio + 1, max(step, 1)):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = [base_size * 0.10] + min_sizes[:n_inputs - 1]
        max_sizes = [base_size * 0.20] + max_sizes[:n_inputs - 1]
    locs, confs, priors, pvars = [], [], [], []
    im_h, im_w = int(image.shape[2]), int(image.shape[3])
    for i, feat in enumerate(inputs):
        ar = aspect_ratios[i]
        n_prior = (len(ar) * (2 if flip else 1) + 1 +
                   (1 if max_sizes else 0))
        c = feat.shape[1]
        loc_conv = nn.Conv2D(c, n_prior * 4, kernel_size, stride,
                             pad).to(feat.device)
        conf_conv = nn.Conv2D(c, n_prior * num_classes, kernel_size,
                              stride, pad).to(feat.device)
        loc = loc_conv(feat).permute(0, 2, 3, 1)
        conf = conf_conv(feat).permute(0, 2, 3, 1)
        locs.append(loc.reshape(feat.shape[0], -1, 4))
        confs.append(conf.reshape(feat.shape[0], -1, num_classes))
        fh, fw = int(feat.shape[2]), int(feat.shape[3])
        sw = steps[i] if steps else im_w / fw
        sh = steps[i] if steps else im_h / fh
        boxes = []
        for y in range(fh):
            for x_ in range(fw):
                cx = (x_ + offset) * sw
                cy = (y + offset) * sh
                sizes = [(min_sizes[i], min_sizes[i])]
                if max_sizes:
                    s = float(np.sqrt(min_sizes[i] * max_sizes[i]))
                    sizes.append((s, s))
                for a in ar:
                    if abs(a - 1.0) < 1e-6:
                        continue
                    w_a = min_sizes[i] * float(np.sqrt(a))
                    h_a = min_sizes[i] / float(np.sqrt(a))
                    sizes.append((w_a, h_a))
                    if flip:
                        sizes.append((h_a, w_a))
                for (bw, bh) in sizes:
                    box = [(cx - bw / 2) / im_w, (cy - bh / 2) / im_h,
                           (cx + bw / 2) / im_w, (cy + bh / 2) / im_h]
                    if clip:
                        box = [min(max(v, 0.0), 1.0) for v in box]
                    boxes.append(box)
        pb = np.asarray(boxes, np.float32)
        priors.append(torch.as_tensor(pb, device=feat.device))
        pvars.append(torch.as_tensor(
            np.tile(np.asarray(variance, np.float32), (len(pb), 1)),
            device=feat.device))
    return (torch.cat(locs, 1), torch.cat(confs, 1), torch.cat(priors, 0),
            torch.cat(pvars, 0))


def continuous_value_model(input, cvm, use_cvm=True):
    """CTR show/click feature handling (reference static/nn/common.py
    continuous_value_model → cvm_op): keep or strip the leading
    show/click pair of each embedding."""
    v = _t(input)
    if use_cvm:
        return torch.cat([_t(cvm).to(v.dtype), v[:, 2:]], -1)
    return v[:, 2:]


class _Tape(TorchFunctionMode):
    """Records every top-level torch call (func, args, kwargs, output)
    while the step block runs."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, out))
        return out


class StaticRNN:
    """Static-unroll RNN builder (reference: static/nn/control_flow.py
    StaticRNN — step block recorded once, executed per time step).

    The `with rnn.step():` body runs ONCE eagerly on the t=0 slice under
    a recording mode (`_Tape`: the torch calls it makes). `rnn()` then
    REPLAYS the recorded calls that depend on the step inputs and
    memories, T times, with each step's slice and the carried memories
    substituted (the JAX package replays its autograd tape the same
    way); everything else (parameters, constants) keeps its value.
    Gradients flow through the replayed ops."""

    def __init__(self, name=None):
        self._seq = []        # (full_sequence_tensor, t0_slice_tensor)
        self._memories = []   # {"init", "pre", "next"}
        self._outputs = []
        self._tape = None

    def step(self):
        @contextlib.contextmanager
        def ctx():
            self._tape = _Tape()
            with self._tape:
                yield self

        return ctx()

    def step_input(self, x):
        x = _t(x)
        sl = x[0].clone()
        self._seq.append((x, sl))
        return sl

    def memory(self, init=None, shape=None, batch_ref=None,
               init_value=0.0, init_batch_dim_idx=0, ref_batch_dim_idx=1):
        if init is None:
            batch = batch_ref.shape[ref_batch_dim_idx]
            init = torch.full((int(batch),) + tuple(shape),
                              float(init_value), dtype=torch.float32,
                              device=_dev(batch_ref))
        init = _t(init)
        pre = init.clone()
        self._memories.append({"init": init, "pre": pre, "next": None})
        return pre

    def update_memory(self, mem_var, new_var):
        for mem in self._memories:
            if mem["pre"] is mem_var:
                mem["next"] = _t(new_var)
                return
        raise ValueError("update_memory: unknown memory var")

    def step_output(self, o):
        self._outputs.append(_t(o))

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _replay(self, subs):
        memo = dict(subs)

        def sub(a):
            return memo.get(id(a), a) if isinstance(a, torch.Tensor) else a

        for func, args, kwargs, out in self._tape.ops:
            leaves = pytree.tree_leaves((args, kwargs))
            if not any(isinstance(a, torch.Tensor) and id(a) in memo
                       for a in leaves):
                continue
            new = func(*pytree.tree_map(sub, args),
                       **pytree.tree_map(sub, kwargs))
            for o, n in zip(pytree.tree_leaves(out),
                            pytree.tree_leaves(new)):
                if isinstance(o, torch.Tensor):
                    memo[id(o)] = n
        return memo

    def __call__(self):
        if not self._seq:
            raise ValueError("StaticRNN has no step_input")
        T = int(self._seq[0][0].shape[0])
        mems = [m["init"] for m in self._memories]
        acc = [[] for _ in self._outputs]
        for t in range(T):
            subs = {id(sl): full[t] for full, sl in self._seq}
            subs.update({id(m["pre"]): v
                         for m, v in zip(self._memories, mems)})
            memo = self._replay(subs)
            for i, o in enumerate(self._outputs):
                acc[i].append(memo.get(id(o), o))
            mems = [memo.get(id(m["next"]), m["next"])
                    if m["next"] is not None else v
                    for m, v in zip(self._memories, mems)]
        outs = [torch.stack(a) for a in acc]
        return outs[0] if len(outs) == 1 else tuple(outs)
