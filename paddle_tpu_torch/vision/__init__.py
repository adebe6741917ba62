"""Vision (counterpart of paddle_tpu/vision; reference
python/paddle/vision/__init__.py): the models, transforms and datasets,
also re-exported flat (`paddle.vision.resnet50`,
`paddle.vision.RandomResizedCrop`), the image backend switch, and
`vision.ops`, the detection primitives."""
from . import datasets, models, ops, transforms  # noqa: F401
from .datasets import *  # noqa: F401,F403
from .models import *  # noqa: F401,F403
from .transforms import *  # noqa: F401,F403

_image_backend = "numpy"


def set_image_backend(backend):
    """The reference takes pil / cv2; decoding here is numpy's."""
    global _image_backend
    if backend not in ("numpy", "pil", "cv2"):
        raise ValueError(f"unknown image backend {backend!r}")
    _image_backend = backend


def get_image_backend():
    return _image_backend


def image_load(path, backend=None):
    """An image file as an HWC numpy array, decoded by PIL; raises where
    PIL is missing (reference: vision/image.py)."""
    import numpy as np

    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            "image_load requires an image decoding backend (PIL), which "
            "this environment does not provide; the datasets of "
            "paddle_tpu_torch.vision.datasets decode their own formats"
        ) from None
    return np.asarray(Image.open(path))
