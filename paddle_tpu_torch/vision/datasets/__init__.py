"""Vision datasets (counterpart of paddle_tpu/vision/datasets; reference
python/paddle/vision/datasets/mnist.py etc.).

Nothing is downloaded: MNIST reads local IDX files when given, and
otherwise MNIST, FashionMNIST and Cifar10 / 100 make the reference's
seeded synthetic substitute, byte for byte (the same shapes, dtypes and
protocol), so training pipelines run unmodified.
"""
import gzip
import os
import struct

import numpy as np

from ...io import Dataset

from .flowers_voc import VOC2012, Flowers  # noqa: E402,F401
from .folder import (  # noqa: E402,F401
    DatasetFolder,
    ImageFolder,
)

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "flowers_synth",
           "Flowers", "VOC2012", "DatasetFolder", "ImageFolder"]


def _synthetic_images(n, shape, num_classes, seed):
    """Deterministic class-correlated images: class k gets a distinct
    frequency pattern + noise, so models can actually fit them."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, n).astype("int64")
    h, w = shape[-2], shape[-1]
    yy, xx = np.mgrid[0:h, 0:w].astype("float32")
    images = np.empty((n,) + tuple(shape), dtype="float32")
    for k in range(num_classes):
        idx = labels == k
        base = np.sin(xx * (k + 1) * np.pi / w) * np.cos(
            yy * (k + 1) * np.pi / h)
        images[idx] = base * 127.5 + 127.5
    images += rng.randn(*images.shape).astype("float32") * 16.0
    return np.clip(images, 0, 255).astype("uint8"), labels


class MNIST(Dataset):
    NUM_CLASSES = 10

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        self.mode = mode
        self.transform = transform
        if image_path and os.path.exists(image_path):
            if not (label_path and os.path.exists(label_path)):
                raise ValueError(
                    "label_path must point to an existing IDX label file "
                    "when image_path is given")
            self.images, self.labels = self._load_idx(image_path, label_path)
        else:
            n = 6000 if mode == "train" else 1000
            imgs, labels = _synthetic_images(
                n, (28, 28), self.NUM_CLASSES,
                seed=0 if mode == "train" else 1)
            self.images = imgs
            self.labels = labels

    @staticmethod
    def _load_idx(image_path, label_path):
        opener = gzip.open if image_path.endswith(".gz") else open
        with opener(image_path, "rb") as f:
            _, n, rows, cols = struct.unpack(">IIII", f.read(16))
            images = np.frombuffer(f.read(), dtype=np.uint8).reshape(
                n, rows, cols)
        opener = gzip.open if label_path.endswith(".gz") else open
        with opener(label_path, "rb") as f:
            struct.unpack(">II", f.read(8))
            labels = np.frombuffer(f.read(), dtype=np.uint8).astype("int64")
        return images, labels

    def __getitem__(self, idx):
        img = self.images[idx]
        label = self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype("float32")[None] / 255.0
        return img, np.asarray(label, dtype="int64")

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    pass


class Cifar10(Dataset):
    NUM_CLASSES = 10

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        self.transform = transform
        n = 5000 if mode == "train" else 1000
        imgs, labels = _synthetic_images(
            n, (3, 32, 32), self.NUM_CLASSES, seed=2 if mode == "train" else 3)
        self.images = imgs
        self.labels = labels

    def __getitem__(self, idx):
        img = self.images[idx]
        label = self.labels[idx]
        if self.transform is not None:
            img = self.transform(img.transpose(1, 2, 0))
        else:
            img = img.astype("float32") / 255.0
        return img, np.asarray(label, dtype="int64")

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    NUM_CLASSES = 100


def flowers_synth(n=256, size=224):
    imgs, labels = _synthetic_images(n, (3, size, size), 102, seed=7)
    return imgs, labels
