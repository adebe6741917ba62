"""Vision models (counterpart of paddle_tpu/vision/models): the ResNet
family and LeNet. The other models are ROADMAP A12's."""
from .lenet import LeNet  # noqa: F401
from .resnet import (ResNet, resnet18, resnet34, resnet50,  # noqa: F401
                     resnet101, resnet152, resnext50_32x4d,
                     resnext50_64x4d, resnext101_32x4d, resnext101_64x4d,
                     resnext152_32x4d, resnext152_64x4d, wide_resnet50_2,
                     wide_resnet101_2)

__all__ = [
    "LeNet", "ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
    "resnet152", "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
    "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d",
    "wide_resnet50_2", "wide_resnet101_2",
]
