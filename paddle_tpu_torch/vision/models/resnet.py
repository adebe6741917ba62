"""The ResNet family (counterpart of paddle_tpu/vision/models/resnet.py):
ResNet-18 to -152, the ResNeXt and wide variants, under the reference's
layer names, so a reference model's `state_dict` (the batch norms'
`_mean` / `_variance` included) loads key for key.

The constructors take the reference's arguments plus `device` (CUDA
unless the caller asks for the CPU) and `seed`: the weights are
the reference's initializers (XavierUniform convs and fc weight, zero
biases, ones / zeros batch norms) drawn from a CPU generator seeded from
`seed`.
"""
import torch
from torch import nn

from ... import nn as pnn
from ...nn.layer.layers import Layer
from ._build import place, seeded_build

__all__ = ["ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152", "resnext50_32x4d", "resnext50_64x4d",
           "resnext101_32x4d", "resnext101_64x4d", "resnext152_32x4d",
           "resnext152_64x4d", "wide_resnet50_2", "wide_resnet101_2"]


class BasicBlock(Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None):
        super().__init__()
        norm_layer = norm_layer or pnn.BatchNorm2D
        self.conv1 = pnn.Conv2D(inplanes, planes, 3, stride=stride,
                                padding=1, bias_attr=False)
        self.bn1 = norm_layer(planes)
        self.relu = pnn.ReLU()
        self.conv2 = pnn.Conv2D(planes, planes, 3, padding=1, bias_attr=False)
        self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None):
        super().__init__()
        norm_layer = norm_layer or pnn.BatchNorm2D
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = pnn.Conv2D(inplanes, width, 1, bias_attr=False)
        self.bn1 = norm_layer(width)
        self.conv2 = pnn.Conv2D(width, width, 3, padding=dilation,
                                stride=stride, groups=groups,
                                dilation=dilation, bias_attr=False)
        self.bn2 = norm_layer(width)
        self.conv3 = pnn.Conv2D(width, planes * self.expansion, 1,
                                bias_attr=False)
        self.bn3 = norm_layer(planes * self.expansion)
        self.relu = pnn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(Layer):
    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, device=None, seed=0):
        super().__init__()
        layers = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                  101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._norm_layer = pnn.BatchNorm2D
        self.inplanes = 64
        self.dilation = 1
        with seeded_build(seed):
            self.conv1 = pnn.Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                                    bias_attr=False)
            self.bn1 = self._norm_layer(self.inplanes)
            self.relu = pnn.ReLU()
            self.maxpool = pnn.MaxPool2D(3, stride=2, padding=1)
            self.layer1 = self._make_layer(block, 64, layers[0])
            self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
            self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
            self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
            if with_pool:
                self.avgpool = pnn.AdaptiveAvgPool2D((1, 1))
            if num_classes > 0:
                self.fc = pnn.Linear(512 * block.expansion, num_classes)
        place(self, device)

    def _make_layer(self, block, planes, blocks, stride=1, dilate=False):
        norm_layer = self._norm_layer
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = pnn.Sequential(
                pnn.Conv2D(self.inplanes, planes * block.expansion, 1,
                           stride=stride, bias_attr=False),
                norm_layer(planes * block.expansion),
            )
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, 1, norm_layer)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                norm_layer=norm_layer))
        return pnn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


def _resnet(block, depth, **kwargs):
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, **kwargs)


def _resnext(depth, groups, width=4):
    def make(pretrained=False, **kwargs):
        kwargs.setdefault("groups", groups)
        kwargs.setdefault("width", width)
        return _resnet(BottleneckBlock, depth, **kwargs)
    make.__name__ = f"resnext{depth}_{groups}x{width}d"
    return make


resnext50_32x4d = _resnext(50, 32)
resnext50_64x4d = _resnext(50, 64)
resnext101_32x4d = _resnext(101, 32)
resnext101_64x4d = _resnext(101, 64)
resnext152_32x4d = _resnext(152, 32)
resnext152_64x4d = _resnext(152, 64)


def wide_resnet50_2(pretrained=False, **kwargs):
    kwargs.setdefault("width", 128)
    return _resnet(BottleneckBlock, 50, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    kwargs.setdefault("width", 128)
    return _resnet(BottleneckBlock, 101, **kwargs)
