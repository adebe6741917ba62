"""LeNet (counterpart of paddle_tpu/vision/models/lenet.py): the
bench_mnist model, [N, 1, 28, 28] → [N, num_classes]."""
import torch
from torch import nn

from ... import nn as pnn
from ...nn.layer.layers import Layer
from ._build import place, seeded_build

__all__ = ["LeNet"]


class LeNet(Layer):
    def __init__(self, num_classes=10, device=None, seed=0):
        super().__init__()
        self.num_classes = num_classes
        with seeded_build(seed):
            self.features = pnn.Sequential(
                pnn.Conv2D(1, 6, 3, stride=1, padding=1),
                pnn.ReLU(),
                pnn.MaxPool2D(2, 2),
                pnn.Conv2D(6, 16, 5, stride=1, padding=0),
                pnn.ReLU(),
                pnn.MaxPool2D(2, 2),
            )
            if num_classes > 0:
                self.fc = pnn.Sequential(
                    pnn.Linear(400, 120),
                    pnn.Linear(120, 84),
                    pnn.Linear(84, num_classes),
                )
        place(self, device)

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x
