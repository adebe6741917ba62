"""DenseNet 121-264 (counterpart of paddle_tpu/vision/models/densenet.py;
reference python/paddle/vision/models/densenet.py), under the
reference's layer names; `device` and `seed` as in mobilenet.py."""
import torch

from ... import nn
from ...nn.layer.layers import Layer
from ._build import place, seeded_build

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet264"]


class DenseLayer(Layer):
    """BN-ReLU-1x1conv (bottleneck) -> BN-ReLU-3x3conv, concat to input."""

    def __init__(self, in_c, growth_rate, bn_size, dropout):
        super().__init__()
        self.norm1 = nn.BatchNorm2D(in_c)
        self.conv1 = nn.Conv2D(in_c, bn_size * growth_rate, 1,
                               bias_attr=False)
        self.norm2 = nn.BatchNorm2D(bn_size * growth_rate)
        self.conv2 = nn.Conv2D(bn_size * growth_rate, growth_rate, 3,
                               padding=1, bias_attr=False)
        self.relu = nn.ReLU()
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x):
        out = self.conv1(self.relu(self.norm1(x)))
        out = self.conv2(self.relu(self.norm2(out)))
        if self.dropout is not None:
            out = self.dropout(out)
        return torch.cat([x, out], dim=1)


class DenseBlock(nn.Sequential):
    def __init__(self, num_layers, in_c, growth_rate, bn_size, dropout):
        super().__init__(*[
            DenseLayer(in_c + i * growth_rate, growth_rate, bn_size, dropout)
            for i in range(num_layers)
        ])


class Transition(nn.Sequential):
    def __init__(self, in_c, out_c):
        super().__init__(
            nn.BatchNorm2D(in_c),
            nn.ReLU(),
            nn.Conv2D(in_c, out_c, 1, bias_attr=False),
            nn.AvgPool2D(2, stride=2),
        )


_ARCH = {
    121: (32, 64, [6, 12, 24, 16]),
    161: (48, 96, [6, 12, 36, 24]),
    169: (32, 64, [6, 12, 32, 32]),
    201: (32, 64, [6, 12, 48, 32]),
    264: (32, 64, [6, 12, 64, 48]),
}


class DenseNet(Layer):
    def __init__(self, layers=121, bn_size=4, dropout=0.0, num_classes=1000,
                 with_pool=True,
                 device=None, seed=0):
        super().__init__()
        with seeded_build(seed):
            growth_rate, num_init, block_cfg = _ARCH[layers]
            self.num_classes = num_classes
            self.with_pool = with_pool
            self.stem = nn.Sequential(
                nn.Conv2D(3, num_init, 7, stride=2, padding=3,
                          bias_attr=False),
                nn.BatchNorm2D(num_init),
                nn.ReLU(),
                nn.MaxPool2D(3, stride=2, padding=1),
            )
            blocks = []
            channels = num_init
            for i, num_layers in enumerate(block_cfg):
                blocks.append(DenseBlock(num_layers, channels, growth_rate,
                                         bn_size, dropout))
                channels += num_layers * growth_rate
                if i != len(block_cfg) - 1:
                    blocks.append(Transition(channels, channels // 2))
                    channels //= 2
            blocks.append(nn.BatchNorm2D(channels))
            blocks.append(nn.ReLU())
            self.features = nn.Sequential(*blocks)
            if with_pool:
                self.avgpool = nn.AdaptiveAvgPool2D(1)
            if num_classes > 0:
                self.classifier = nn.Linear(channels, num_classes)
        place(self, device)

    def forward(self, x):
        x = self.features(self.stem(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = torch.flatten(x, 1)
            x = self.classifier(x)
        return x


def densenet121(pretrained=False, **kwargs):
    return DenseNet(layers=121, **kwargs)


def densenet161(pretrained=False, **kwargs):
    return DenseNet(layers=161, **kwargs)


def densenet169(pretrained=False, **kwargs):
    return DenseNet(layers=169, **kwargs)


def densenet201(pretrained=False, **kwargs):
    return DenseNet(layers=201, **kwargs)


def densenet264(pretrained=False, **kwargs):
    return DenseNet(layers=264, **kwargs)
