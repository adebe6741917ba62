"""Flowers-102 and VOC2012 segmentation (counterpart of
paddle_tpu/vision/datasets/flowers_voc.py; reference
python/paddle/vision/datasets/flowers.py:33, voc2012.py:30).

Local archives only, the files the reference downloads — Flowers:
102flowers.tgz + imagelabels.mat + setid.mat; VOC: the VOCtrainval tar
with JPEGImages / SegmentationClass / ImageSets. PIL (and scipy for the
.mat files) are imported when used."""
import io as _io
import tarfile

import numpy as np

from ...io import Dataset

__all__ = ["Flowers", "VOC2012"]


def _require(v, name, hint):
    if v is None:
        raise ValueError(
            f"{name}: downloads are unavailable here — pass {hint}")
    return v


class Flowers(Dataset):
    """102-category flowers: (image HWC uint8, label int64 in [0, 102))
    (reference flowers.py:33; split ids from setid.mat — trnid/valid/
    tstid)."""

    MODE_KEY = {"train": "trnid", "valid": "valid", "test": "tstid"}

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=False,
                 backend=None):
        import scipy.io

        assert mode in self.MODE_KEY
        self.transform = transform
        data_file = _require(data_file, "Flowers",
                             "data_file=102flowers.tgz")
        label_file = _require(label_file, "Flowers",
                              "label_file=imagelabels.mat")
        setid_file = _require(setid_file, "Flowers",
                              "setid_file=setid.mat")
        labels = scipy.io.loadmat(label_file)["labels"].ravel()
        ids = scipy.io.loadmat(setid_file)[
            self.MODE_KEY[mode]].ravel()
        wanted = {f"image_{i:05d}.jpg": i for i in ids}
        found = set()
        self._images, self._labels = [], []
        with tarfile.open(data_file) as tf:
            for m in tf.getmembers():
                base = m.name.rsplit("/", 1)[-1]
                if m.isfile() and base in wanted:
                    i = wanted[base]
                    found.add(base)
                    self._images.append(tf.extractfile(m).read())
                    self._labels.append(np.int64(labels[i - 1] - 1))
        missing = set(wanted) - found
        if missing:  # a silently truncated split trains on partial data
            raise RuntimeError(
                f"archive is missing {len(missing)} of {len(wanted)} "
                f"split images (e.g. {sorted(missing)[:3]})")

    def __len__(self):
        return len(self._images)

    def __getitem__(self, idx):
        from PIL import Image

        img = np.asarray(Image.open(
            _io.BytesIO(self._images[idx])).convert("RGB"))
        if self.transform is not None:
            img = self.transform(img)
        return img, self._labels[idx]


class VOC2012(Dataset):
    """Segmentation pairs (image HWC uint8, mask HW uint8)
    (reference voc2012.py:30; split lists from
    ImageSets/Segmentation/{train,val,trainval}.txt)."""

    SPLIT = {"train": "train.txt", "valid": "val.txt",
             "test": "trainval.txt"}

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None):
        assert mode in self.SPLIT
        self.transform = transform
        data_file = _require(data_file, "VOC2012",
                             "data_file=VOCtrainval tar")
        # pass 1: only the split list — pass 2 reads JUST that split's
        # files (buffering all ~17k images for a 1.4k split would cost
        # multi-GB of transient RAM on the real archive)
        with tarfile.open(data_file) as tf:
            names = None
            for m in tf.getmembers():
                if m.isfile() and m.name.endswith(
                        "ImageSets/Segmentation/" + self.SPLIT[mode]):
                    names = tf.extractfile(m).read().decode().split()
                    break
            if names is None:
                raise RuntimeError(
                    f"split list {self.SPLIT[mode]} not found in archive")
            want = set(names)
            images, masks = {}, {}
            for m in tf.getmembers():
                if not m.isfile():
                    continue
                n = m.name
                base = n.rsplit("/", 1)[-1][:-4]
                if ("/JPEGImages/" in n and n.endswith(".jpg")
                        and base in want):
                    images[base] = tf.extractfile(m).read()
                elif ("/SegmentationClass/" in n and n.endswith(".png")
                      and base in want):
                    masks[base] = tf.extractfile(m).read()
        self._pairs = [(images[n], masks[n]) for n in names
                       if n in images and n in masks]
        if not self._pairs:
            raise RuntimeError("no image/mask pairs for the split")

    def __len__(self):
        return len(self._pairs)

    def __getitem__(self, idx):
        from PIL import Image

        raw_img, raw_mask = self._pairs[idx]
        img = np.asarray(Image.open(_io.BytesIO(raw_img)).convert("RGB"))
        mask = np.asarray(Image.open(_io.BytesIO(raw_mask)))
        if self.transform is not None:
            img = self.transform(img)
        return img, mask
