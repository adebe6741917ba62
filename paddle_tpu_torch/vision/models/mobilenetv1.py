"""MobileNetV1 (counterpart of paddle_tpu/vision/models/mobilenetv1.py;
reference python/paddle/vision/models/mobilenetv1.py)."""
import functools

import torch

from ... import nn
from ...nn.layer.layers import Layer
from ._build import place, seeded_build
from .mobilenet import ConvBNReLU as _ConvBNAct

__all__ = ["MobileNetV1", "mobilenet_v1"]

ConvBNReLU = functools.partial(_ConvBNAct, activation=nn.ReLU)


class DepthwiseSeparable(nn.Sequential):
    """3x3 depthwise conv + 1x1 pointwise conv, each with BN+ReLU."""

    def __init__(self, in_c, out_c, stride):
        super().__init__(
            ConvBNReLU(in_c, in_c, stride=stride, groups=in_c),
            ConvBNReLU(in_c, out_c, kernel=1),
        )


class MobileNetV1(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 device=None, seed=0):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return max(1, int(ch * scale))

        # (out_channels, stride) after the stem, the paper's Table 1
        cfg = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
               (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
               (1024, 1)]
        with seeded_build(seed):
            layers = [ConvBNReLU(3, c(32), stride=2)]
            in_c = c(32)
            for out, stride in cfg:
                layers.append(DepthwiseSeparable(in_c, c(out), stride))
                in_c = c(out)
            self.features = nn.Sequential(*layers)
            self.out_channels = in_c
            if with_pool:
                self.pool2d_avg = nn.AdaptiveAvgPool2D(1)
            if num_classes > 0:
                self.fc = nn.Linear(in_c, num_classes)
        place(self, device)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV1(scale=scale, **kwargs)
