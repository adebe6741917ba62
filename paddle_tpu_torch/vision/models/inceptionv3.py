"""Inception-v3 (counterpart of paddle_tpu/vision/models/inceptionv3.py;
reference python/paddle/vision/models/inceptionv3.py), under the
reference's layer names; `device` and `seed` as in mobilenet.py."""
import torch

from ... import nn
from ...nn.layer.layers import Layer
from ._build import place, seeded_build

__all__ = ["InceptionV3", "inception_v3"]


class ConvBNAct(nn.Sequential):
    def __init__(self, in_c, out_c, kernel, stride=1, padding=0):
        super().__init__(
            nn.Conv2D(in_c, out_c, kernel, stride, padding, bias_attr=False),
            nn.BatchNorm2D(out_c),
            nn.ReLU(),
        )


class InceptionA(Layer):
    """35x35 block: 1x1 / 5x5 / double-3x3 / pool-proj branches."""

    def __init__(self, in_c, pool_features):
        super().__init__()
        self.b1 = ConvBNAct(in_c, 64, 1)
        self.b5 = nn.Sequential(
            ConvBNAct(in_c, 48, 1), ConvBNAct(48, 64, 5, padding=2))
        self.b3dbl = nn.Sequential(
            ConvBNAct(in_c, 64, 1),
            ConvBNAct(64, 96, 3, padding=1),
            ConvBNAct(96, 96, 3, padding=1))
        self.bpool = nn.Sequential(
            nn.AvgPool2D(3, stride=1, padding=1),
            ConvBNAct(in_c, pool_features, 1))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b5(x), self.b3dbl(x),
                       self.bpool(x)], dim=1)


class InceptionB(Layer):
    """35->17 grid reduction."""

    def __init__(self, in_c):
        super().__init__()
        self.b3 = ConvBNAct(in_c, 384, 3, stride=2)
        self.b3dbl = nn.Sequential(
            ConvBNAct(in_c, 64, 1),
            ConvBNAct(64, 96, 3, padding=1),
            ConvBNAct(96, 96, 3, stride=2))
        self.pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return torch.cat([self.b3(x), self.b3dbl(x), self.pool(x)], dim=1)


class InceptionC(Layer):
    """17x17 block with factorized 7x7 convolutions."""

    def __init__(self, in_c, c7):
        super().__init__()
        self.b1 = ConvBNAct(in_c, 192, 1)
        self.b7 = nn.Sequential(
            ConvBNAct(in_c, c7, 1),
            ConvBNAct(c7, c7, (1, 7), padding=(0, 3)),
            ConvBNAct(c7, 192, (7, 1), padding=(3, 0)))
        self.b7dbl = nn.Sequential(
            ConvBNAct(in_c, c7, 1),
            ConvBNAct(c7, c7, (7, 1), padding=(3, 0)),
            ConvBNAct(c7, c7, (1, 7), padding=(0, 3)),
            ConvBNAct(c7, c7, (7, 1), padding=(3, 0)),
            ConvBNAct(c7, 192, (1, 7), padding=(0, 3)))
        self.bpool = nn.Sequential(
            nn.AvgPool2D(3, stride=1, padding=1), ConvBNAct(in_c, 192, 1))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b7(x), self.b7dbl(x),
                       self.bpool(x)], dim=1)


class InceptionD(Layer):
    """17->8 grid reduction."""

    def __init__(self, in_c):
        super().__init__()
        self.b3 = nn.Sequential(
            ConvBNAct(in_c, 192, 1), ConvBNAct(192, 320, 3, stride=2))
        self.b7x3 = nn.Sequential(
            ConvBNAct(in_c, 192, 1),
            ConvBNAct(192, 192, (1, 7), padding=(0, 3)),
            ConvBNAct(192, 192, (7, 1), padding=(3, 0)),
            ConvBNAct(192, 192, 3, stride=2))
        self.pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return torch.cat([self.b3(x), self.b7x3(x), self.pool(x)], dim=1)


class InceptionE(Layer):
    """8x8 block with expanded 3x1/1x3 filter banks."""

    def __init__(self, in_c):
        super().__init__()
        self.b1 = ConvBNAct(in_c, 320, 1)
        self.b3_stem = ConvBNAct(in_c, 384, 1)
        self.b3_1x3 = ConvBNAct(384, 384, (1, 3), padding=(0, 1))
        self.b3_3x1 = ConvBNAct(384, 384, (3, 1), padding=(1, 0))
        self.b3dbl_stem = nn.Sequential(
            ConvBNAct(in_c, 448, 1), ConvBNAct(448, 384, 3, padding=1))
        self.b3dbl_1x3 = ConvBNAct(384, 384, (1, 3), padding=(0, 1))
        self.b3dbl_3x1 = ConvBNAct(384, 384, (3, 1), padding=(1, 0))
        self.bpool = nn.Sequential(
            nn.AvgPool2D(3, stride=1, padding=1), ConvBNAct(in_c, 192, 1))

    def forward(self, x):
        s = self.b3_stem(x)
        b3 = torch.cat([self.b3_1x3(s), self.b3_3x1(s)], dim=1)
        d = self.b3dbl_stem(x)
        b3dbl = torch.cat([self.b3dbl_1x3(d), self.b3dbl_3x1(d)], dim=1)
        return torch.cat([self.b1(x), b3, b3dbl, self.bpool(x)], dim=1)


class InceptionV3(Layer):
    def __init__(self, num_classes=1000, with_pool=True,
                 device=None, seed=0):
        super().__init__()
        with seeded_build(seed):
            self.num_classes = num_classes
            self.with_pool = with_pool
            self.stem = nn.Sequential(
                ConvBNAct(3, 32, 3, stride=2),
                ConvBNAct(32, 32, 3),
                ConvBNAct(32, 64, 3, padding=1),
                nn.MaxPool2D(3, stride=2),
                ConvBNAct(64, 80, 1),
                ConvBNAct(80, 192, 3),
                nn.MaxPool2D(3, stride=2),
            )
            self.blocks = nn.Sequential(
                InceptionA(192, pool_features=32),
                InceptionA(256, pool_features=64),
                InceptionA(288, pool_features=64),
                InceptionB(288),
                InceptionC(768, c7=128),
                InceptionC(768, c7=160),
                InceptionC(768, c7=160),
                InceptionC(768, c7=192),
                InceptionD(768),
                InceptionE(1280),
                InceptionE(2048),
            )
            if with_pool:
                self.avgpool = nn.AdaptiveAvgPool2D(1)
            if num_classes > 0:
                self.dropout = nn.Dropout(0.5)
                self.fc = nn.Linear(2048, num_classes)
        place(self, device)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(torch.flatten(x, 1)))
        return x


def inception_v3(pretrained=False, **kwargs):
    return InceptionV3(**kwargs)
