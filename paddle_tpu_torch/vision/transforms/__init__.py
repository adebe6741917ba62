"""Vision transforms over numpy HWC arrays and CPU tensors (counterpart
of paddle_tpu/vision/transforms; reference
python/paddle/vision/transforms/transforms.py).

The reference's rules, not torchvision's: `resize` ignores
`interpolation` and samples nearest by floor (input index
floor(i · in / out), `_resize_np`; ROADMAP C), `RandomResizedCrop` takes
up to 10 tries and then a centre crop, the random transforms draw from
Python's `random` and numpy's global stream. `ToTensor` gives a CPU
float32 tensor.
"""
import numbers

import numpy as np
import torch

__all__ = [
    "Compose", "ToTensor", "Normalize", "Resize", "RandomCrop", "CenterCrop",
    "RandomHorizontalFlip", "RandomVerticalFlip", "Transpose", "Pad",
    "BaseTransform", "normalize", "to_tensor", "resize", "hflip", "vflip",
]


def _as_hwc(img):
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    return img


def to_tensor(pic, data_format="CHW"):
    img = _as_hwc(pic)
    if img.dtype == np.uint8:
        img = img.astype("float32") / 255.0
    else:
        img = img.astype("float32")
    if data_format == "CHW":
        img = img.transpose(2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(img))


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    is_tensor = isinstance(img, torch.Tensor)
    arr = img.detach().cpu().numpy() if is_tensor else np.asarray(img)
    arr = arr.astype("float32")
    mean = np.asarray(mean, dtype="float32")
    std = np.asarray(std, dtype="float32")
    if data_format == "CHW":
        arr = (arr - mean.reshape(-1, 1, 1)) / std.reshape(-1, 1, 1)
    else:
        arr = (arr - mean) / std
    return torch.from_numpy(arr) if is_tensor else arr


def _resize_np(img, size):
    """Nearest-neighbour resize for HWC numpy (no PIL dependency)."""
    h, w = img.shape[:2]
    if isinstance(size, int):
        if h <= w:
            oh, ow = size, int(size * w / h)
        else:
            oh, ow = int(size * h / w), size
    else:
        oh, ow = size
    ri = (np.arange(oh) * h / oh).astype(int).clip(0, h - 1)
    ci = (np.arange(ow) * w / ow).astype(int).clip(0, w - 1)
    return img[ri[:, None], ci[None, :]]


def resize(img, size, interpolation="bilinear"):
    return _resize_np(_as_hwc(img), size)


def hflip(img):
    return _as_hwc(img)[:, ::-1]


def vflip(img):
    return _as_hwc(img)[::-1]


class BaseTransform:
    def __init__(self, keys=None):
        self.keys = keys

    def __call__(self, inputs):
        return self._apply_image(inputs)

    def _apply_image(self, img):
        raise NotImplementedError


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        super().__init__(keys)
        self.data_format = data_format

    def _apply_image(self, img):
        return to_tensor(img, self.data_format)


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False,
                 keys=None):
        super().__init__(keys)
        if isinstance(mean, numbers.Number):
            mean = [mean] * 3
        if isinstance(std, numbers.Number):
            std = [std] * 3
        self.mean, self.std = mean, std
        self.data_format = data_format

    def _apply_image(self, img):
        return normalize(img, self.mean, self.std, self.data_format)


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = size

    def _apply_image(self, img):
        return _resize_np(_as_hwc(img), self.size)


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, int) else size
        if isinstance(padding, int):
            padding = (padding,) * 4  # left, top, right, bottom
        elif padding is not None and len(padding) == 2:
            padding = (padding[0], padding[1], padding[0], padding[1])
        self.padding = padding
        self.pad_if_needed = pad_if_needed
        self.fill = fill

    def _apply_image(self, img):
        img = _as_hwc(img)
        th, tw = self.size
        if self.padding is not None:
            l, t, r, b = self.padding
            img = np.pad(img, ((t, b), (l, r), (0, 0)),
                         constant_values=self.fill)
        h, w = img.shape[:2]
        if self.pad_if_needed and h < th:
            d = th - h
            img = np.pad(img, ((d, d), (0, 0), (0, 0)),
                         constant_values=self.fill)
        if self.pad_if_needed and w < tw:
            d = tw - w
            img = np.pad(img, ((0, 0), (d, d), (0, 0)),
                         constant_values=self.fill)
        h, w = img.shape[:2]
        if h < th or w < tw:
            raise ValueError(
                f"image ({h},{w}) smaller than crop {self.size}; pass "
                "padding= or pad_if_needed=True")
        if h == th and w == tw:
            return img
        i = np.random.randint(0, h - th + 1)
        j = np.random.randint(0, w - tw + 1)
        return img[i: i + th, j: j + tw]


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, int) else size

    def _apply_image(self, img):
        img = _as_hwc(img)
        h, w = img.shape[:2]
        th, tw = self.size
        if h < th or w < tw:
            raise ValueError(
                f"image ({h},{w}) smaller than CenterCrop size {self.size}")
        i = (h - th) // 2
        j = (w - tw) // 2
        return img[i: i + th, j: j + tw]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        if np.random.rand() < self.prob:
            return hflip(img)
        return _as_hwc(img)


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        if np.random.rand() < self.prob:
            return vflip(img)
        return _as_hwc(img)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = order

    def _apply_image(self, img):
        return _as_hwc(img).transpose(self.order)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        super().__init__(keys)
        if isinstance(padding, int):
            padding = (padding,) * 4
        self.padding = padding
        self.fill = fill

    def _apply_image(self, img):
        img = _as_hwc(img)
        l, t, r, b = (self.padding if len(self.padding) == 4
                      else self.padding * 2)
        return np.pad(img, ((t, b), (l, r), (0, 0)), constant_values=self.fill)


# Color / geometry transforms and their functional ops (separate modules;
# imported last so they can subclass BaseTransform).
from . import functional  # noqa: E402,F401
from .functional import (  # noqa: E402,F401
    adjust_brightness,
    adjust_contrast,
    adjust_hue,
    adjust_saturation,
    affine,
    center_crop,
    crop,
    erase,
    perspective,
    rotate,
    to_grayscale,
)
from .color_geometry import (  # noqa: E402,F401
    BrightnessTransform,
    ColorJitter,
    ContrastTransform,
    Grayscale,
    HueTransform,
    RandomAffine,
    RandomErasing,
    RandomPerspective,
    RandomResizedCrop,
    RandomRotation,
    SaturationTransform,
)

__all__ += [
    "RandomResizedCrop", "BrightnessTransform", "ContrastTransform",
    "SaturationTransform", "HueTransform", "ColorJitter", "Grayscale",
    "RandomRotation", "RandomAffine", "RandomPerspective", "RandomErasing",
    "adjust_brightness", "adjust_contrast", "adjust_saturation",
    "adjust_hue", "rotate", "affine", "perspective", "erase", "crop",
    "center_crop", "to_grayscale", "functional",
]


def pad(img, padding, fill=0, padding_mode="constant"):
    """Functional pad (reference: vision/transforms/functional.py pad)."""
    img = _as_hwc(img)
    if isinstance(padding, numbers.Number):
        padding = (padding,) * 4
    elif len(padding) == 2:
        padding = (padding[0], padding[1], padding[0], padding[1])
    l, t, r, b = padding
    cfg = ((t, b), (l, r), (0, 0))
    if padding_mode == "constant":
        return np.pad(img, cfg, constant_values=fill)
    mode = {"edge": "edge", "reflect": "reflect",
            "symmetric": "symmetric"}[padding_mode]
    return np.pad(img, cfg, mode=mode)


__all__.append("pad")
