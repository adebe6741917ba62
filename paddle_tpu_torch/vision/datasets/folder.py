"""Folder-layout datasets (counterpart of
paddle_tpu/vision/datasets/folder.py; reference
python/paddle/vision/datasets/folder.py — DatasetFolder:38,
ImageFolder:220). The default loader decodes with PIL, imported when a
file is read; pass `loader=` where PIL is missing (`np.load` for a
folder of `.npy` arrays)."""
import os

import numpy as np

from ...io import Dataset

__all__ = ["DatasetFolder", "ImageFolder", "default_loader",
           "IMG_EXTENSIONS"]

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm",
                  ".tif", ".tiff", ".webp")


def default_loader(path):
    """jpg/png → HWC uint8 numpy (the transforms operate on arrays)."""
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def _has_allowed_ext(name, extensions):
    return name.lower().endswith(tuple(extensions))


class DatasetFolder(Dataset):
    """root/class_x/xxx.ext layout → (sample, class_index)
    (reference folder.py:38)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        if extensions and is_valid_file:  # not assert: survives -O
            raise ValueError(
                "pass either extensions or is_valid_file, not both")
        self.root = root
        self.loader = loader or default_loader
        self.transform = transform
        extensions = extensions or IMG_EXTENSIONS
        classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise RuntimeError(f"no class folders under {root}")
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        valid = (is_valid_file if is_valid_file is not None
                 else (lambda p: _has_allowed_ext(p, extensions)))
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for base, _, files in sorted(os.walk(cdir)):
                for f in sorted(files):
                    p = os.path.join(base, f)
                    if valid(p):
                        self.samples.append((p, self.class_to_idx[c]))
        if not self.samples:
            raise RuntimeError(f"no valid files found under {root}")

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        path, target = self.samples[i]
        sample = self.loader(path)
        if self.transform is not None:
            sample = self.transform(sample)
        return sample, target


class ImageFolder(Dataset):
    """Flat (possibly nested) image directory → [sample] — no labels
    (reference folder.py:220)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.loader = loader or default_loader
        self.transform = transform
        extensions = extensions or IMG_EXTENSIONS
        valid = (is_valid_file if is_valid_file is not None
                 else (lambda p: _has_allowed_ext(p, extensions)))
        self.samples = []
        for base, _, files in sorted(os.walk(root)):
            for f in sorted(files):
                p = os.path.join(base, f)
                if valid(p):
                    self.samples.append(p)
        if not self.samples:
            raise RuntimeError(f"no valid files found under {root}")

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        sample = self.loader(self.samples[i])
        if self.transform is not None:
            sample = self.transform(sample)
        return [sample]
