"""GoogLeNet / Inception-v1 (counterpart of
paddle_tpu/vision/models/googlenet.py; reference
python/paddle/vision/models/googlenet.py); `device` and `seed` as in
mobilenet.py.

`forward` returns (out, aux1, aux2) like the reference: the two auxiliary
classifier heads are always computed (callers discard them at eval).
"""
import torch

from ... import nn
from ...nn.layer.layers import Layer
from ._build import place, seeded_build

__all__ = ["GoogLeNet", "googlenet"]


class ConvReLU(nn.Sequential):
    def __init__(self, in_c, out_c, kernel, stride=1, padding=0):
        super().__init__(
            nn.Conv2D(in_c, out_c, kernel, stride, padding),
            nn.ReLU(),
        )


class Inception(Layer):
    """Four parallel branches (1x1 / 3x3 / 5x5 / pool-proj), channel concat."""

    def __init__(self, in_c, c1, c3r, c3, c5r, c5, proj):
        super().__init__()
        self.branch1 = ConvReLU(in_c, c1, 1)
        self.branch2 = nn.Sequential(
            ConvReLU(in_c, c3r, 1), ConvReLU(c3r, c3, 3, padding=1))
        self.branch3 = nn.Sequential(
            ConvReLU(in_c, c5r, 1), ConvReLU(c5r, c5, 5, padding=2))
        self.branch4 = nn.Sequential(
            nn.MaxPool2D(3, stride=1, padding=1), ConvReLU(in_c, proj, 1))

    def forward(self, x):
        return torch.cat([self.branch1(x), self.branch2(x), self.branch3(x),
                       self.branch4(x)], dim=1)


class AuxHead(Layer):
    def __init__(self, in_c, num_classes):
        super().__init__()
        self.pool = nn.AdaptiveAvgPool2D(4)
        self.conv = ConvReLU(in_c, 128, 1)
        self.fc1 = nn.Linear(128 * 16, 1024)
        self.relu = nn.ReLU()
        self.dropout = nn.Dropout(0.7)
        self.fc2 = nn.Linear(1024, num_classes)

    def forward(self, x):
        x = self.conv(self.pool(x))
        x = self.relu(self.fc1(torch.flatten(x, 1)))
        return self.fc2(self.dropout(x))


class GoogLeNet(Layer):
    def __init__(self, num_classes=1000, with_pool=True,
                 device=None, seed=0):
        super().__init__()
        with seeded_build(seed):
            self.num_classes = num_classes
            self.with_pool = with_pool
            self.stem = nn.Sequential(
                ConvReLU(3, 64, 7, stride=2, padding=3),
                nn.MaxPool2D(3, stride=2, padding=1),
                ConvReLU(64, 64, 1),
                ConvReLU(64, 192, 3, padding=1),
                nn.MaxPool2D(3, stride=2, padding=1),
            )
            self.inc3a = Inception(192, 64, 96, 128, 16, 32, 32)
            self.inc3b = Inception(256, 128, 128, 192, 32, 96, 64)
            self.pool3 = nn.MaxPool2D(3, stride=2, padding=1)
            self.inc4a = Inception(480, 192, 96, 208, 16, 48, 64)
            self.inc4b = Inception(512, 160, 112, 224, 24, 64, 64)
            self.inc4c = Inception(512, 128, 128, 256, 24, 64, 64)
            self.inc4d = Inception(512, 112, 144, 288, 32, 64, 64)
            self.inc4e = Inception(528, 256, 160, 320, 32, 128, 128)
            self.pool4 = nn.MaxPool2D(3, stride=2, padding=1)
            self.inc5a = Inception(832, 256, 160, 320, 32, 128, 128)
            self.inc5b = Inception(832, 384, 192, 384, 48, 128, 128)
            if with_pool:
                self.avgpool = nn.AdaptiveAvgPool2D(1)
            if num_classes > 0:
                self.dropout = nn.Dropout(0.4)
                self.fc = nn.Linear(1024, num_classes)
                self.aux1 = AuxHead(512, num_classes)
                self.aux2 = AuxHead(528, num_classes)
        place(self, device)

    def forward(self, x):
        x = self.stem(x)
        x = self.pool3(self.inc3b(self.inc3a(x)))
        x = self.inc4a(x)
        aux1 = self.aux1(x) if self.num_classes > 0 else None
        x = self.inc4d(self.inc4c(self.inc4b(x)))
        aux2 = self.aux2(x) if self.num_classes > 0 else None
        x = self.pool4(self.inc4e(x))
        x = self.inc5b(self.inc5a(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(torch.flatten(x, 1)))
        return x, aux1, aux2


def googlenet(pretrained=False, **kwargs):
    return GoogLeNet(**kwargs)
