"""paddle.flops — a forward's FLOPs counted layer by layer through forward
hooks (counterpart of paddle_tpu/hapi/dynamic_flops.py; reference
python/paddle/hapi/dynamic_flops.py).

The reference's convention: one multiply-accumulate counts as one FLOP
for convolutions and linears (plus one a bias output), 2 an element for
the norms, 1 an element for activations and pooled outputs. Linear
weights are paddle's [in, out]; a convolution's `in_c` is
`weight.shape[1]`, already in_channels // groups.
"""
import torch

from .. import nn

__all__ = ["flops"]


def _numel(shape):
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _count_conv(layer, inp, out):
    # MACs = out_elems * (in_channels/groups * prod(kernel))
    kernel = layer._kernel_size if hasattr(layer, "_kernel_size") else \
        layer.weight.shape[2:]
    in_c = layer.weight.shape[1]  # already in_channels // groups
    macs = _numel(out.shape) * in_c * _numel(kernel)
    bias = _numel(out.shape) if getattr(layer, "bias", None) is not None else 0
    return macs + bias


def _count_linear(layer, inp, out):
    in_f = layer.weight.shape[0]
    macs = _numel(out.shape) * in_f
    bias = _numel(out.shape) if getattr(layer, "bias", None) is not None else 0
    return macs + bias


def _count_norm(layer, inp, out):
    return 2 * _numel(inp.shape)


def _count_act(layer, inp, out):
    return _numel(inp.shape)


def _count_pool(layer, inp, out):
    return _numel(out.shape)


_COUNTERS = {
    nn.Conv1D: _count_conv, nn.Conv2D: _count_conv, nn.Conv3D: _count_conv,
    nn.Conv1DTranspose: _count_conv, nn.Conv2DTranspose: _count_conv,
    nn.Conv3DTranspose: _count_conv,
    nn.Linear: _count_linear,
    nn.BatchNorm1D: _count_norm, nn.BatchNorm2D: _count_norm,
    nn.BatchNorm3D: _count_norm, nn.BatchNorm: _count_norm,
    nn.LayerNorm: _count_norm, nn.GroupNorm: _count_norm,
    nn.ReLU: _count_act, nn.ReLU6: _count_act, nn.Sigmoid: _count_act,
    nn.Hardswish: _count_act, nn.Hardsigmoid: _count_act,
    nn.LeakyReLU: _count_act, nn.GELU: _count_act, nn.Swish: _count_act,
    nn.AvgPool1D: _count_pool, nn.AvgPool2D: _count_pool,
    nn.AvgPool3D: _count_pool, nn.MaxPool1D: _count_pool,
    nn.MaxPool2D: _count_pool, nn.MaxPool3D: _count_pool,
    nn.AdaptiveAvgPool1D: _count_pool, nn.AdaptiveAvgPool2D: _count_pool,
    nn.AdaptiveAvgPool3D: _count_pool,
}


def flops(net, input_size, custom_ops=None, print_detail=False):
    """Total FLOPs of one forward (eval mode) on zeros of `input_size`,
    on the network's device."""
    counters = dict(_COUNTERS)
    if custom_ops:
        counters.update(custom_ops)
    rows = []
    handles = []

    def _make_hook(counter):
        def hook(layer, inputs, output):
            inp = inputs[0] if isinstance(inputs, (tuple, list)) else inputs
            out = output[0] if isinstance(output, (tuple, list)) else output
            n = int(counter(layer, inp, out))
            rows.append((type(layer).__name__, list(inp.shape),
                         list(out.shape),
                         sum(_numel(p.shape) for p in
                             layer.parameters(include_sublayers=False)), n))

        return hook

    for layer in net.sublayers(include_self=True):
        counter = counters.get(type(layer))
        if counter is not None:
            handles.append(layer.register_forward_post_hook(
                _make_hook(counter)))

    device = next((p.device for p in net.parameters()),
                  torch.device("cpu"))
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(torch.zeros(tuple(input_size), dtype=torch.float32,
                            device=device))
    finally:
        for h in handles:
            h.remove()
        if was_training:
            net.train()

    total = sum(r[-1] for r in rows)
    if print_detail:
        print(f"{'Layer':<22}{'Input':<20}{'Output':<20}"
              f"{'Params':>12}{'FLOPs':>16}")
        for name, i, o, p, f in rows:
            print(f"{name:<22}{str(i):<20}{str(o):<20}{p:>12}{f:>16}")
        print(f"Total FLOPs: {total}")
    return total
