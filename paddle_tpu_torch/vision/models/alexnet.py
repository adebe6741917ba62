"""AlexNet (counterpart of paddle_tpu/vision/models/alexnet.py;
reference python/paddle/vision/models/alexnet.py), under the
reference's layer names; `device` and `seed` as in mobilenet.py."""
import torch

from ... import nn
from ...nn.layer.layers import Layer
from ._build import place, seeded_build

__all__ = ["AlexNet", "alexnet"]


class AlexNet(Layer):
    """Classic 5-conv / 3-fc AlexNet, stride-4 stem."""

    def __init__(self, num_classes=1000, with_pool=True, dropout=0.5,
                 device=None, seed=0):
        super().__init__()
        with seeded_build(seed):
            self.num_classes = num_classes
            self.with_pool = with_pool
            self.features = nn.Sequential(
                nn.Conv2D(3, 64, 11, stride=4, padding=2),
                nn.ReLU(),
                nn.MaxPool2D(3, stride=2),
                nn.Conv2D(64, 192, 5, padding=2),
                nn.ReLU(),
                nn.MaxPool2D(3, stride=2),
                nn.Conv2D(192, 384, 3, padding=1),
                nn.ReLU(),
                nn.Conv2D(384, 256, 3, padding=1),
                nn.ReLU(),
                nn.Conv2D(256, 256, 3, padding=1),
                nn.ReLU(),
                nn.MaxPool2D(3, stride=2),
            )
            if with_pool:
                self.avgpool = nn.AdaptiveAvgPool2D((6, 6))
            if num_classes > 0:
                self.classifier = nn.Sequential(
                    nn.Dropout(dropout),
                    nn.Linear(256 * 6 * 6, 4096),
                    nn.ReLU(),
                    nn.Dropout(dropout),
                    nn.Linear(4096, 4096),
                    nn.ReLU(),
                    nn.Linear(4096, num_classes),
                )
        place(self, device)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = torch.flatten(x, 1)
            x = self.classifier(x)
        return x


def alexnet(pretrained=False, **kwargs):
    return AlexNet(**kwargs)
