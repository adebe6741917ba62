"""Color-jitter and geometric random transforms (counterpart of
paddle_tpu/vision/transforms/color_geometry.py; reference
python/paddle/vision/transforms/transforms.py
RandomResizedCrop:566, ColorJitter:1188, RandomRotation:1260,
RandomAffine, RandomPerspective, Grayscale, RandomErasing:1744)."""
import math
import numbers
import random

import numpy as np
import torch

from . import functional as F
from .functional import _as_hwc

__all__ = [
    "RandomResizedCrop", "BrightnessTransform", "ContrastTransform",
    "SaturationTransform", "HueTransform", "ColorJitter", "Grayscale",
    "RandomRotation", "RandomAffine", "RandomPerspective", "RandomErasing",
]


def _base():
    from . import BaseTransform

    return BaseTransform


class RandomResizedCrop(_base()):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def _get_param(self, img):
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = area * random.uniform(*self.scale)
            log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
            aspect = math.exp(random.uniform(*log_ratio))
            cw = int(round(math.sqrt(target_area * aspect)))
            ch = int(round(math.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                i = random.randint(0, h - ch)
                j = random.randint(0, w - cw)
                return i, j, ch, cw
        # fallback: center crop at in-range aspect
        in_ratio = w / h
        if in_ratio < self.ratio[0]:
            cw, ch = w, int(round(w / self.ratio[0]))
        elif in_ratio > self.ratio[1]:
            ch, cw = h, int(round(h * self.ratio[1]))
        else:
            cw, ch = w, h
        return (h - ch) // 2, (w - cw) // 2, ch, cw

    def _apply_image(self, img):
        from . import resize

        img = _as_hwc(img)
        i, j, ch, cw = self._get_param(img)
        return resize(img[i: i + ch, j: j + cw], self.size,
                      self.interpolation)


class BrightnessTransform(_base()):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = _check_jitter(value, "brightness")

    def _apply_image(self, img):
        if self.value is None:
            return _as_hwc(img)
        return F.adjust_brightness(img, random.uniform(*self.value))


class ContrastTransform(_base()):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = _check_jitter(value, "contrast")

    def _apply_image(self, img):
        if self.value is None:
            return _as_hwc(img)
        return F.adjust_contrast(img, random.uniform(*self.value))


class SaturationTransform(_base()):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = _check_jitter(value, "saturation")

    def _apply_image(self, img):
        if self.value is None:
            return _as_hwc(img)
        return F.adjust_saturation(img, random.uniform(*self.value))


class HueTransform(_base()):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = _check_jitter(value, "hue", center=0,
                                   bound=(-0.5, 0.5))

    def _apply_image(self, img):
        if self.value is None:
            return _as_hwc(img)
        return F.adjust_hue(img, random.uniform(*self.value))


def _check_jitter(value, name, center=1, bound=(0, float("inf"))):
    if isinstance(value, numbers.Number):
        if value < 0:
            raise ValueError(f"{name} jitter must be non-negative")
        value = [center - value, center + value]
        value[0] = max(value[0], bound[0])
        value[1] = min(value[1], bound[1])
    else:
        value = [float(value[0]), float(value[1])]
    if value[0] == value[1] == center:
        return None
    return tuple(value)


class ColorJitter(_base()):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        super().__init__(keys)
        self.transforms = [
            BrightnessTransform(brightness),
            ContrastTransform(contrast),
            SaturationTransform(saturation),
            HueTransform(hue),
        ]

    def _apply_image(self, img):
        order = list(range(4))
        random.shuffle(order)
        for idx in order:
            img = self.transforms[idx]._apply_image(img)
        return img


class Grayscale(_base()):
    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return F.to_grayscale(img, self.num_output_channels)


class RandomRotation(_base()):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        super().__init__(keys)
        if isinstance(degrees, numbers.Number):
            if degrees < 0:
                raise ValueError("degrees must be non-negative")
            degrees = (-degrees, degrees)
        self.degrees = degrees
        self.interpolation = interpolation
        self.expand = expand
        self.center = center
        self.fill = fill

    def _apply_image(self, img):
        angle = random.uniform(*self.degrees)
        return F.rotate(img, angle, self.interpolation, self.expand,
                        self.center, self.fill)


class RandomAffine(_base()):
    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None, keys=None):
        super().__init__(keys)
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees
        self.translate = translate
        self.scale = scale
        if isinstance(shear, numbers.Number):
            shear = (-shear, shear)
        self.shear = shear
        self.interpolation = interpolation
        self.fill = fill
        self.center = center

    def _apply_image(self, img):
        img = _as_hwc(img)
        h, w = img.shape[:2]
        angle = random.uniform(*self.degrees)
        translate = (0, 0)
        if self.translate is not None:
            tx = random.uniform(-self.translate[0], self.translate[0]) * w
            ty = random.uniform(-self.translate[1], self.translate[1]) * h
            translate = (int(round(tx)), int(round(ty)))
        scale = 1.0
        if self.scale is not None:
            scale = random.uniform(*self.scale)
        shear = (0.0, 0.0)
        if self.shear is not None:
            if len(self.shear) == 2:
                shear = (random.uniform(*self.shear), 0.0)
            else:
                shear = (random.uniform(self.shear[0], self.shear[1]),
                         random.uniform(self.shear[2], self.shear[3]))
        return F.affine(img, angle, translate, scale, shear,
                        self.interpolation, self.fill, self.center)


class RandomPerspective(_base()):
    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation="nearest", fill=0, keys=None):
        super().__init__(keys)
        self.prob = prob
        self.distortion_scale = distortion_scale
        self.interpolation = interpolation
        self.fill = fill

    def _apply_image(self, img):
        img = _as_hwc(img)
        if random.random() >= self.prob:
            return img
        h, w = img.shape[:2]
        d = self.distortion_scale
        half_h, half_w = int(h * d / 2), int(w * d / 2)
        tl = [random.randint(0, max(half_w, 0)),
              random.randint(0, max(half_h, 0))]
        tr = [w - 1 - random.randint(0, max(half_w, 0)),
              random.randint(0, max(half_h, 0))]
        br = [w - 1 - random.randint(0, max(half_w, 0)),
              h - 1 - random.randint(0, max(half_h, 0))]
        bl = [random.randint(0, max(half_w, 0)),
              h - 1 - random.randint(0, max(half_h, 0))]
        start = [[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]]
        end = [tl, tr, br, bl]
        return F.perspective(img, start, end, self.interpolation, self.fill)


class RandomErasing(_base()):
    """Operates on CHW tensors or HWC arrays after ToTensor
    (reference: transforms.py RandomErasing)."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, keys=None):
        super().__init__(keys)
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value
        self.inplace = inplace

    def _apply_image(self, img):
        if random.random() >= self.prob:
            return img
        if isinstance(img, torch.Tensor):
            h, w = img.shape[-2], img.shape[-1]
        else:
            img = _as_hwc(img)
            h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * random.uniform(*self.scale)
            log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
            aspect = math.exp(random.uniform(*log_ratio))
            eh = int(round(math.sqrt(target / aspect)))
            ew = int(round(math.sqrt(target * aspect)))
            if eh < h and ew < w:
                i = random.randint(0, h - eh)
                j = random.randint(0, w - ew)
                if self.value == "random":
                    v = np.random.standard_normal(
                        (eh, ew) if not isinstance(img, torch.Tensor)
                        else (eh, ew)).astype("float32")
                else:
                    v = self.value
                return F.erase(img, i, j, eh, ew, v, self.inplace)
        return img
