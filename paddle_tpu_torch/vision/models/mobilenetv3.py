"""MobileNetV3 small / large (counterpart of
paddle_tpu/vision/models/mobilenetv3.py; reference
python/paddle/vision/models/mobilenetv3.py)."""
import torch

from ... import nn
from ...nn.layer.layers import Layer
from ._build import place, seeded_build
from .mobilenet import _make_divisible

__all__ = ["MobileNetV3Small", "MobileNetV3Large", "mobilenet_v3_small",
           "mobilenet_v3_large"]


class SqueezeExcitation(Layer):
    """Channel SE with relu->hardsigmoid gating."""

    def __init__(self, channels, squeeze_channels):
        super().__init__()
        self.avgpool = nn.AdaptiveAvgPool2D(1)
        self.fc1 = nn.Conv2D(channels, squeeze_channels, 1)
        self.fc2 = nn.Conv2D(squeeze_channels, channels, 1)
        self.relu = nn.ReLU()
        self.hardsigmoid = nn.Hardsigmoid()

    def forward(self, x):
        s = self.avgpool(x)
        s = self.relu(self.fc1(s))
        return x * self.hardsigmoid(self.fc2(s))


class ConvBNAct(nn.Sequential):
    def __init__(self, in_c, out_c, kernel=3, stride=1, groups=1,
                 activation=nn.Hardswish):
        layers = [
            nn.Conv2D(in_c, out_c, kernel, stride,
                      padding=(kernel - 1) // 2, groups=groups,
                      bias_attr=False),
            nn.BatchNorm2D(out_c),
        ]
        if activation is not None:
            layers.append(activation())
        super().__init__(*layers)


class InvertedResidualV3(Layer):
    def __init__(self, in_c, expand_c, out_c, kernel, stride, use_se,
                 use_hs):
        super().__init__()
        act = nn.Hardswish if use_hs else nn.ReLU
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if expand_c != in_c:
            layers.append(ConvBNAct(in_c, expand_c, 1, activation=act))
        layers.append(ConvBNAct(expand_c, expand_c, kernel, stride,
                                groups=expand_c, activation=act))
        if use_se:
            layers.append(SqueezeExcitation(
                expand_c, _make_divisible(expand_c // 4)))
        layers.append(ConvBNAct(expand_c, out_c, 1, activation=None))
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


class MobileNetV3(Layer):
    def __init__(self, cfg, last_channel, scale=1.0, num_classes=1000,
                 with_pool=True, device=None, seed=0):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        with seeded_build(seed):
            self._build(cfg, last_channel, scale, num_classes, with_pool)
        place(self, device)

    def _build(self, cfg, last_channel, scale, num_classes, with_pool):
        def c(ch):
            return _make_divisible(ch * scale)

        in_c = c(16)
        layers = [ConvBNAct(3, in_c, 3, stride=2)]
        for kernel, expand, out, use_se, use_hs, stride in cfg:
            layers.append(InvertedResidualV3(
                in_c, c(expand), c(out), kernel, stride, use_se, use_hs))
            in_c = c(out)
        last_conv = 6 * in_c
        layers.append(ConvBNAct(in_c, last_conv, 1))
        self.features = nn.Sequential(*layers)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(last_conv, last_channel),
                nn.Hardswish(),
                nn.Dropout(0.2),
                nn.Linear(last_channel, num_classes),
            )

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(torch.flatten(x, 1))
        return x


# (kernel, expand, out, use_se, use_hs, stride)
_LARGE_CFG = [
    (3, 16, 16, False, False, 1),
    (3, 64, 24, False, False, 2),
    (3, 72, 24, False, False, 1),
    (5, 72, 40, True, False, 2),
    (5, 120, 40, True, False, 1),
    (5, 120, 40, True, False, 1),
    (3, 240, 80, False, True, 2),
    (3, 200, 80, False, True, 1),
    (3, 184, 80, False, True, 1),
    (3, 184, 80, False, True, 1),
    (3, 480, 112, True, True, 1),
    (3, 672, 112, True, True, 1),
    (5, 672, 160, True, True, 2),
    (5, 960, 160, True, True, 1),
    (5, 960, 160, True, True, 1),
]

_SMALL_CFG = [
    (3, 16, 16, True, False, 2),
    (3, 72, 24, False, False, 2),
    (3, 88, 24, False, False, 1),
    (5, 96, 40, True, True, 2),
    (5, 240, 40, True, True, 1),
    (5, 240, 40, True, True, 1),
    (5, 120, 48, True, True, 1),
    (5, 144, 48, True, True, 1),
    (5, 288, 96, True, True, 2),
    (5, 576, 96, True, True, 1),
    (5, 576, 96, True, True, 1),
]


class MobileNetV3Large(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, seed=0):
        super().__init__(_LARGE_CFG, last_channel=1280, scale=scale,
                         num_classes=num_classes, with_pool=with_pool,
                         device=device, seed=seed)


class MobileNetV3Small(MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, seed=0):
        super().__init__(_SMALL_CFG, last_channel=1024, scale=scale,
                         num_classes=num_classes, with_pool=with_pool,
                         device=device, seed=seed)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV3Small(scale=scale, **kwargs)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV3Large(scale=scale, **kwargs)
