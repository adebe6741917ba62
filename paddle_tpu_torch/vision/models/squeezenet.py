"""SqueezeNet 1.0 / 1.1 (counterpart of paddle_tpu/vision/models/squeezenet.py;
reference python/paddle/vision/models/squeezenet.py), under the
reference's layer names; `device` and `seed` as in mobilenet.py."""
import torch

from ... import nn
from ...nn.layer.layers import Layer
from ._build import place, seeded_build

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class Fire(Layer):
    """squeeze 1x1 -> parallel expand 1x1 / expand 3x3, channel-concat."""

    def __init__(self, inplanes, squeeze_planes, expand1x1, expand3x3):
        super().__init__()
        self.squeeze = nn.Conv2D(inplanes, squeeze_planes, 1)
        self.expand1x1 = nn.Conv2D(squeeze_planes, expand1x1, 1)
        self.expand3x3 = nn.Conv2D(squeeze_planes, expand3x3, 3, padding=1)
        self.relu = nn.ReLU()

    def forward(self, x):
        x = self.relu(self.squeeze(x))
        return torch.cat(
            [self.relu(self.expand1x1(x)), self.relu(self.expand3x3(x))],
            axis=1)


class SqueezeNet(Layer):
    def __init__(self, version="1.0", num_classes=1000, with_pool=True,
                 dropout=0.5,
                 device=None, seed=0):
        super().__init__()
        with seeded_build(seed):
            self.num_classes = num_classes
            self.with_pool = with_pool
            if version == "1.0":
                self.features = nn.Sequential(
                    nn.Conv2D(3, 96, 7, stride=2),
                    nn.ReLU(),
                    nn.MaxPool2D(3, stride=2),
                    Fire(96, 16, 64, 64),
                    Fire(128, 16, 64, 64),
                    Fire(128, 32, 128, 128),
                    nn.MaxPool2D(3, stride=2),
                    Fire(256, 32, 128, 128),
                    Fire(256, 48, 192, 192),
                    Fire(384, 48, 192, 192),
                    Fire(384, 64, 256, 256),
                    nn.MaxPool2D(3, stride=2),
                    Fire(512, 64, 256, 256),
                )
            elif version == "1.1":
                self.features = nn.Sequential(
                    nn.Conv2D(3, 64, 3, stride=2),
                    nn.ReLU(),
                    nn.MaxPool2D(3, stride=2),
                    Fire(64, 16, 64, 64),
                    Fire(128, 16, 64, 64),
                    nn.MaxPool2D(3, stride=2),
                    Fire(128, 32, 128, 128),
                    Fire(256, 32, 128, 128),
                    nn.MaxPool2D(3, stride=2),
                    Fire(256, 48, 192, 192),
                    Fire(384, 48, 192, 192),
                    Fire(384, 64, 256, 256),
                    Fire(512, 64, 256, 256),
                )
            else:
                raise ValueError(f"unsupported SqueezeNet version {version!r}")
            if num_classes > 0:
                self.classifier = nn.Sequential(
                    nn.Dropout(dropout),
                    nn.Conv2D(512, num_classes, 1),
                    nn.ReLU(),
                )
            if with_pool:
                self.avgpool = nn.AdaptiveAvgPool2D(1)
        place(self, device)

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = self.classifier(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = torch.flatten(x, 1)
        return x


def squeezenet1_0(pretrained=False, **kwargs):
    return SqueezeNet(version="1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    return SqueezeNet(version="1.1", **kwargs)
