"""MobileNetV2 (counterpart of paddle_tpu/vision/models/mobilenet.py;
reference python/paddle/vision/models/mobilenetv2.py; Sandler et al.
2018): inverted residuals with linear bottlenecks, under the
reference's layer names, so its `state_dict` loads key for key.

Like every model of the zoo it takes the reference's arguments plus
`device` (CUDA unless the caller asks for the CPU) and `seed`: the
reference's initializers drawn from a CPU generator seeded from `seed`.
"""
import torch

from ... import nn
from ...nn.layer.layers import Layer
from ._build import place, seeded_build

__all__ = ["MobileNetV2", "mobilenet_v2"]


def _make_divisible(v, divisor=8, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNReLU(nn.Sequential):
    def __init__(self, in_c, out_c, kernel=3, stride=1, groups=1,
                 activation=nn.ReLU6):
        super().__init__(
            nn.Conv2D(in_c, out_c, kernel, stride,
                      padding=(kernel - 1) // 2, groups=groups,
                      bias_attr=False),
            nn.BatchNorm2D(out_c),
            activation(),
        )


class InvertedResidual(Layer):
    def __init__(self, inp, oup, stride, expand_ratio):
        super().__init__()
        self.stride = stride
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU(inp, hidden, kernel=1))
        layers.extend([
            ConvBNReLU(hidden, hidden, stride=stride, groups=hidden),
            nn.Conv2D(hidden, oup, 1, bias_attr=False),
            nn.BatchNorm2D(oup),
        ])
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        return x + self.conv(x) if self.use_res else self.conv(x)


class MobileNetV2(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, seed=0):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        input_channel = _make_divisible(32 * scale)
        settings = [
            [1, 16, 1, 1], [6, 24, 2, 2], [6, 32, 3, 2], [6, 64, 4, 2],
            [6, 96, 3, 1], [6, 160, 3, 2], [6, 320, 1, 1],
        ]
        with seeded_build(seed):
            features = [ConvBNReLU(3, input_channel, stride=2)]
            for t, c, n, s in settings:
                out_c = _make_divisible(c * scale)
                for i in range(n):
                    features.append(InvertedResidual(
                        input_channel, out_c, s if i == 0 else 1, t))
                    input_channel = out_c
            self.last_channel = _make_divisible(1280 * max(1.0, scale))
            features.append(ConvBNReLU(input_channel, self.last_channel,
                                       kernel=1))
            self.features = nn.Sequential(*features)
            if with_pool:
                self.pool2d_avg = nn.AdaptiveAvgPool2D(1)
            if num_classes > 0:
                self.classifier = nn.Sequential(
                    nn.Dropout(0.2), nn.Linear(self.last_channel,
                                               num_classes))
        place(self, device)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV2(scale=scale, **kwargs)
