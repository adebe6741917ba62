"""ShuffleNetV2, every width and the swish variant (counterpart of
paddle_tpu/vision/models/shufflenetv2.py;
reference python/paddle/vision/models/shufflenetv2.py), under the
reference's layer names; `device` and `seed` as in mobilenet.py."""
import torch

from ... import nn
from ...nn.layer.layers import Layer
from ._build import place, seeded_build

__all__ = ["ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
           "shufflenet_v2_x2_0", "shufflenet_v2_swish"]


def _conv_bn(in_c, out_c, kernel, stride, groups=1, act=None):
    layers = [
        nn.Conv2D(in_c, out_c, kernel, stride,
                  padding=(kernel - 1) // 2, groups=groups, bias_attr=False),
        nn.BatchNorm2D(out_c),
    ]
    if act is not None:
        layers.append(act())
    return nn.Sequential(*layers)


class InvertedResidualUnit(Layer):
    """stride-1 unit: split channels, transform one half, shuffle."""

    def __init__(self, channels, act):
        super().__init__()
        assert channels % 2 == 0
        branch = channels // 2
        self.branch2 = nn.Sequential(
            _conv_bn(branch, branch, 1, 1, act=act),
            _conv_bn(branch, branch, 3, 1, groups=branch),
            _conv_bn(branch, branch, 1, 1, act=act),
        )
        self.shuffle = nn.ChannelShuffle(2)

    def forward(self, x):
        half = x.shape[1] // 2
        x1, x2 = x[:, :half], x[:, half:]
        out = torch.cat([x1, self.branch2(x2)], dim=1)
        return self.shuffle(out)


class InvertedResidualDS(Layer):
    """stride-2 downsampling unit: both branches transformed, shuffle."""

    def __init__(self, in_c, out_c, act):
        super().__init__()
        branch = out_c // 2
        self.branch1 = nn.Sequential(
            _conv_bn(in_c, in_c, 3, 2, groups=in_c),
            _conv_bn(in_c, branch, 1, 1, act=act),
        )
        self.branch2 = nn.Sequential(
            _conv_bn(in_c, branch, 1, 1, act=act),
            _conv_bn(branch, branch, 3, 2, groups=branch),
            _conv_bn(branch, branch, 1, 1, act=act),
        )
        self.shuffle = nn.ChannelShuffle(2)

    def forward(self, x):
        out = torch.cat([self.branch1(x), self.branch2(x)], dim=1)
        return self.shuffle(out)


_STAGE_REPEATS = [4, 8, 4]

_STAGE_OUT = {
    0.25: [24, 24, 48, 96, 512],
    0.33: [24, 32, 64, 128, 512],
    0.5: [24, 48, 96, 192, 1024],
    1.0: [24, 116, 232, 464, 1024],
    1.5: [24, 176, 352, 704, 1024],
    2.0: [24, 244, 488, 976, 2048],
}


class ShuffleNetV2(Layer):
    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True,
                 device=None, seed=0):
        super().__init__()
        with seeded_build(seed):
            self.num_classes = num_classes
            self.with_pool = with_pool
            act_layer = nn.Swish if act == "swish" else nn.ReLU
            out_c = _STAGE_OUT[scale]
            self.conv1 = _conv_bn(3, out_c[0], 3, 2, act=act_layer)
            self.max_pool = nn.MaxPool2D(3, stride=2, padding=1)
            blocks = []
            in_c = out_c[0]
            for stage, repeats in enumerate(_STAGE_REPEATS):
                stage_out = out_c[stage + 1]
                blocks.append(InvertedResidualDS(in_c, stage_out, act_layer))
                for _ in range(repeats - 1):
                    blocks.append(InvertedResidualUnit(stage_out, act_layer))
                in_c = stage_out
            self.blocks = nn.Sequential(*blocks)
            self.conv_last = _conv_bn(in_c, out_c[-1], 1, 1, act=act_layer)
            if with_pool:
                self.avgpool = nn.AdaptiveAvgPool2D(1)
            if num_classes > 0:
                self.fc = nn.Linear(out_c[-1], num_classes)
        place(self, device)

    def forward(self, x):
        x = self.max_pool(self.conv1(x))
        x = self.blocks(x)
        x = self.conv_last(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = torch.flatten(x, 1)
            x = self.fc(x)
        return x


def shufflenet_v2_x0_25(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=0.25, **kwargs)


def shufflenet_v2_x0_33(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=0.33, **kwargs)


def shufflenet_v2_x0_5(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=0.5, **kwargs)


def shufflenet_v2_x1_0(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=1.0, **kwargs)


def shufflenet_v2_x1_5(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=1.5, **kwargs)


def shufflenet_v2_x2_0(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=2.0, **kwargs)


def shufflenet_v2_swish(pretrained=False, **kwargs):
    return ShuffleNetV2(scale=1.0, act="swish", **kwargs)
