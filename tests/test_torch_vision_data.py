"""Vision transforms and datasets (paddle_tpu_torch/vision/transforms,
vision/datasets, vision/__init__) against the JAX package's on the CPU.

Every transform, class and functional, runs on the same uint8 / float32
HWC images (and CHW tensors where it takes them) under the same
`random.seed` / `np.random.seed`; the outputs must be equal, element for
element and in dtype (both packages compute in numpy; a tensor output
is compared through its array). The synthetic datasets (MNIST,
FashionMNIST, Cifar10 / 100, flowers_synth) must be equal byte for byte,
and the local-file readers (MNIST's IDX files, DatasetFolder,
ImageFolder, Flowers, VOC2012) must read the same samples from files
the test writes.
"""
import gzip
import io
import random
import struct
import tarfile

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import vision as JV
from paddle_tpu.vision import datasets as JD
from paddle_tpu.vision import transforms as JT
from paddle_tpu.vision.transforms import functional as JF
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import vision as TV
from paddle_tpu_torch.vision import datasets as TD
from paddle_tpu_torch.vision import transforms as TT
from paddle_tpu_torch.vision.transforms import functional as TFn

pytestmark = pytest.mark.torch_port


def _arr(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if hasattr(x, "numpy"):
        return np.asarray(x.numpy())
    return np.asarray(x)


def _same(got, want):
    g, w = _arr(got), _arr(want)
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w)


def _img(seed=0, h=37, w=45, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return rng.random((h, w, 3)).astype(dtype)


def _run(make, img, seed, draws=3):
    """`draws` applications of the transform `make(T)` of each package,
    from the same Python and numpy seeds."""
    out = []
    for T in (JT, TT):
        random.seed(seed)
        np.random.seed(seed)
        t = make(T)
        out.append([t(img) for _ in range(draws)])
    return out


# (name, factory over the transforms module, input dtype)
CLASS_CASES = [
    ("Compose", lambda T: T.Compose([T.CenterCrop(20), T.Transpose()]),
     np.uint8),
    ("ToTensor", lambda T: T.ToTensor(), np.uint8),
    ("ToTensor-HWC-float", lambda T: T.ToTensor(data_format="HWC"),
     np.float32),
    ("Normalize-HWC", lambda T: T.Normalize([10.0, 20.0, 30.0],
                                            [2.0, 3.0, 4.0],
                                            data_format="HWC"), np.uint8),
    ("Normalize-scalar", lambda T: T.Compose([T.Transpose(),
                                              T.Normalize(0.5, 0.25)]),
     np.float32),
    ("Resize-int", lambda T: T.Resize(24), np.uint8),
    ("Resize-pair", lambda T: T.Resize((50, 17)), np.uint8),
    ("RandomCrop", lambda T: T.RandomCrop(20), np.uint8),
    ("RandomCrop-pad", lambda T: T.RandomCrop(40, padding=3, fill=7),
     np.uint8),
    ("RandomCrop-pad-if-needed", lambda T: T.RandomCrop(
        (50, 20), pad_if_needed=True), np.uint8),
    ("CenterCrop", lambda T: T.CenterCrop((21, 30)), np.uint8),
    ("RandomHorizontalFlip", lambda T: T.RandomHorizontalFlip(), np.uint8),
    ("RandomVerticalFlip", lambda T: T.RandomVerticalFlip(0.7), np.uint8),
    ("Transpose", lambda T: T.Transpose((1, 0, 2)), np.uint8),
    ("Pad", lambda T: T.Pad((1, 2, 3, 4), fill=9), np.uint8),
    ("RandomResizedCrop", lambda T: T.RandomResizedCrop(16), np.uint8),
    ("RandomResizedCrop-fallback", lambda T: T.RandomResizedCrop(
        (12, 14), scale=(2.0, 3.0), ratio=(5.0, 6.0)), np.uint8),
    ("BrightnessTransform", lambda T: T.BrightnessTransform(0.4), np.uint8),
    ("ContrastTransform", lambda T: T.ContrastTransform(0.4), np.uint8),
    ("SaturationTransform", lambda T: T.SaturationTransform(0.4),
     np.uint8),
    ("HueTransform", lambda T: T.HueTransform(0.3), np.uint8),
    ("HueTransform-float", lambda T: T.HueTransform(0.3), np.float32),
    ("ColorJitter", lambda T: T.ColorJitter(0.3, 0.3, 0.3, 0.1), np.uint8),
    ("Grayscale", lambda T: T.Grayscale(3), np.uint8),
    ("RandomRotation", lambda T: T.RandomRotation(30), np.uint8),
    ("RandomRotation-expand-bilinear", lambda T: T.RandomRotation(
        (10, 50), interpolation="bilinear", expand=True, fill=3), np.uint8),
    ("RandomAffine", lambda T: T.RandomAffine(
        20, translate=(0.1, 0.2), scale=(0.8, 1.2), shear=10), np.uint8),
    ("RandomAffine-4-shear", lambda T: T.RandomAffine(
        0, shear=(-5, 5, -8, 8), interpolation="bilinear"), np.float32),
    ("RandomPerspective", lambda T: T.RandomPerspective(prob=1.0),
     np.uint8),
    ("RandomErasing", lambda T: T.RandomErasing(prob=1.0, value=17),
     np.uint8),
]


@pytest.mark.parametrize("name,make,dtype", CLASS_CASES,
                         ids=[c[0] for c in CLASS_CASES])
def test_transform_equals_the_reference(name, make, dtype):
    img = _img(1, dtype=dtype)
    for seed in (0, 3):
        want, got = _run(make, img, seed)
        for g, w in zip(got, want):
            _same(g, w)


@pytest.mark.parametrize("value", [0.5, "random"])
def test_random_erasing_on_a_chw_tensor_equals_the_reference(value):
    img = _img(2, dtype=np.float32).transpose(2, 0, 1).copy()
    out = []
    for T, mk in ((JT, paddle.to_tensor), (TT, torch.from_numpy)):
        random.seed(4)
        np.random.seed(4)
        t = T.RandomErasing(prob=1.0, value=value)
        out.append(t(mk(img.copy())))
    assert isinstance(out[1], torch.Tensor)
    _same(out[1], out[0])


def test_random_erasing_random_value_on_an_hwc_array_raises_as_the_reference():
    """ROADMAP C: value="random" draws an (h, w) patch, which does not
    broadcast over an HWC array's channels; both packages raise."""
    img = _img(2, dtype=np.float32)
    for T in (JT, TT):
        random.seed(4)
        with pytest.raises(ValueError, match="broadcast"):
            T.RandomErasing(prob=1.0, value="random")(img)


def test_to_tensor_and_normalize_on_a_tensor():
    img = _img(3)
    j = JT.normalize(JT.to_tensor(img), [0.1, 0.2, 0.3], [0.5, 0.5, 0.5])
    t = TT.normalize(TT.to_tensor(img), [0.1, 0.2, 0.3], [0.5, 0.5, 0.5])
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    _same(t, j)


FUNCTIONAL_CASES = [
    ("resize", lambda F, T, a: T.resize(a, 19)),
    ("hflip", lambda F, T, a: T.hflip(a)),
    ("vflip", lambda F, T, a: T.vflip(a)),
    ("pad-constant", lambda F, T, a: T.pad(a, (2, 3), fill=5)),
    ("pad-edge", lambda F, T, a: T.pad(a, 2, padding_mode="edge")),
    ("pad-reflect", lambda F, T, a: T.pad(a, (1, 2, 3, 4),
                                          padding_mode="reflect")),
    ("pad-symmetric", lambda F, T, a: T.pad(a, 3,
                                            padding_mode="symmetric")),
    ("adjust_brightness", lambda F, T, a: F.adjust_brightness(a, 1.3)),
    ("adjust_contrast", lambda F, T, a: F.adjust_contrast(a, 0.6)),
    ("adjust_saturation", lambda F, T, a: F.adjust_saturation(a, 1.7)),
    ("adjust_hue", lambda F, T, a: F.adjust_hue(a, -0.2)),
    ("to_grayscale", lambda F, T, a: F.to_grayscale(a)),
    ("rotate", lambda F, T, a: F.rotate(a, 33.0)),
    ("rotate-expand", lambda F, T, a: F.rotate(
        a, -21.0, interpolation="bilinear", expand=True, center=(3, 4))),
    ("affine", lambda F, T, a: F.affine(a, 12.0, (3, -2), 1.1, (5.0, 2.0))),
    ("affine-bilinear", lambda F, T, a: F.affine(
        a, -7.0, (0, 0), 0.9, 4.0, interpolation="bilinear", fill=2)),
    ("perspective", lambda F, T, a: F.perspective(
        a, [[0, 0], [44, 0], [44, 36], [0, 36]],
        [[3, 2], [40, 1], [43, 30], [1, 35]])),
    ("perspective-bilinear", lambda F, T, a: F.perspective(
        a, [[0, 0], [44, 0], [44, 36], [0, 36]],
        [[5, 1], [42, 4], [40, 33], [2, 34]], interpolation="bilinear")),
    ("erase", lambda F, T, a: F.erase(a, 3, 4, 10, 12, 0)),
    ("crop", lambda F, T, a: F.crop(a, 2, 5, 20, 11)),
    ("center_crop", lambda F, T, a: F.center_crop(a, 17)),
]


@pytest.mark.parametrize("name,call", FUNCTIONAL_CASES,
                         ids=[c[0] for c in FUNCTIONAL_CASES])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_functional_equals_the_reference(name, call, dtype):
    img = _img(5, dtype=dtype)
    _same(call(TFn, TT, img.copy()), call(JF, JT, img.copy()))


def test_resize_samples_nearest_by_floor_whatever_the_interpolation():
    """ROADMAP C: `resize` ignores `interpolation`; output pixel i takes
    input pixel floor(i · in / out)."""
    img = np.arange(5 * 7, dtype=np.uint8).reshape(5, 7, 1)
    got = TT.resize(img, (3, 4), interpolation="bicubic")
    ri = (np.arange(3) * 5 / 3).astype(int)
    ci = (np.arange(4) * 7 / 4).astype(int)
    np.testing.assert_array_equal(got, img[ri[:, None], ci[None, :]])


# ---- datasets ---------------------------------------------------------------

@pytest.mark.parametrize("name,mode", [("MNIST", "train"), ("MNIST", "test"),
                                       ("FashionMNIST", "test"),
                                       ("Cifar10", "train"),
                                       ("Cifar10", "test"),
                                       ("Cifar100", "test")])
def test_synthetic_datasets_equal_the_reference_byte_for_byte(name, mode):
    j = getattr(JD, name)(mode=mode)
    t = getattr(TD, name)(mode=mode)
    assert len(t) == len(j)
    assert t.images.tobytes() == j.images.tobytes()
    assert t.labels.tobytes() == j.labels.tobytes()
    for i in (0, len(t) - 1):
        for a, b in zip(t[i], j[i]):
            _same(a, b)


def test_synthetic_datasets_with_a_transform_and_flowers_synth():
    tj = JT.Compose([JT.Resize(20), JT.Normalize(127.5, 127.5,
                                                 data_format="HWC")])
    tt = TT.Compose([TT.Resize(20), TT.Normalize(127.5, 127.5,
                                                 data_format="HWC")])
    j = JD.Cifar10(mode="test", transform=tj)
    t = TD.Cifar10(mode="test", transform=tt)
    for i in (0, 5):
        for a, b in zip(t[i], j[i]):
            _same(a, b)
    ji, jl = JD.flowers_synth(n=16, size=32)
    ti, tl = TD.flowers_synth(n=16, size=32)
    assert ti.tobytes() == ji.tobytes() and tl.tobytes() == jl.tobytes()


def _idx(tmp_path, n=7):
    rng = np.random.default_rng(6)
    imgs = rng.integers(0, 256, (n, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, n).astype(np.uint8)
    ip, lp = tmp_path / "imgs.gz", tmp_path / "labels"
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return str(ip), str(lp)


def test_mnist_reads_local_idx_files_as_the_reference(tmp_path):
    ip, lp = _idx(tmp_path)
    j = JD.MNIST(image_path=ip, label_path=lp)
    t = TD.MNIST(image_path=ip, label_path=lp)
    assert len(t) == len(j) == 7
    for i in range(7):
        for a, b in zip(t[i], j[i]):
            _same(a, b)
    with pytest.raises(ValueError, match="label_path"):
        TD.MNIST(image_path=ip)


def _png(path, arr):
    from PIL import Image

    Image.fromarray(arr).save(path)


def _jpg_bytes(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG")
    return buf.getvalue()


def _png_bytes(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def test_folders_read_the_reference_s_samples(tmp_path):
    rng = np.random.default_rng(7)
    root = tmp_path / "tree"
    for cls in ("dog", "cat"):
        (root / cls / "deep").mkdir(parents=True)
        for i in range(2):
            _png(root / cls / f"{i}.png",
                 rng.integers(0, 256, (9, 11, 3), dtype=np.uint8))
        _png(root / cls / "deep" / "x.png",
             rng.integers(0, 256, (9, 11, 3), dtype=np.uint8))
        (root / cls / "notes.txt").write_text("skip me")
    j = JD.DatasetFolder(str(root))
    t = TD.DatasetFolder(str(root))
    assert t.classes == j.classes == ["cat", "dog"]
    assert t.samples == j.samples and len(t) == 6
    for i in range(6):
        for a, b in zip(t[i], j[i]):
            _same(a, b)
    ji, ti = JD.ImageFolder(str(root)), TD.ImageFolder(str(root))
    assert ti.samples == ji.samples
    _same(ti[3][0], ji[3][0])
    with pytest.raises(ValueError):
        TD.DatasetFolder(str(root), extensions=(".png",),
                         is_valid_file=lambda p: True)


def test_flowers_and_voc_read_local_archives_as_the_reference(tmp_path):
    import scipy.io

    n = 5
    with tarfile.open(tmp_path / "102flowers.tgz", "w:gz") as tf:
        for i in range(1, n + 1):
            data = _jpg_bytes(np.full((10, 12, 3), i * 30, np.uint8))
            info = tarfile.TarInfo(f"jpg/image_{i:05d}.jpg")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    scipy.io.savemat(tmp_path / "imagelabels.mat",
                     {"labels": np.array([[3, 1, 4, 1, 5]])})
    scipy.io.savemat(tmp_path / "setid.mat",
                     {"trnid": np.array([[1, 2, 4]]),
                      "valid": np.array([[5]]), "tstid": np.array([[3]])})
    kw = dict(data_file=str(tmp_path / "102flowers.tgz"),
              label_file=str(tmp_path / "imagelabels.mat"),
              setid_file=str(tmp_path / "setid.mat"))
    for mode in ("train", "test"):
        j, t = JD.Flowers(mode=mode, **kw), TD.Flowers(mode=mode, **kw)
        assert len(t) == len(j)
        for i in range(len(t)):
            for a, b in zip(t[i], j[i]):
                _same(a, b)
    with pytest.raises(ValueError, match="downloads"):
        TD.Flowers()

    names = ["2007_000001", "2007_000002"]
    with tarfile.open(tmp_path / "voc.tar", "w") as tf:
        lst = ("\n".join(names) + "\n").encode()
        info = tarfile.TarInfo(
            "VOCdevkit/VOC2012/ImageSets/Segmentation/train.txt")
        info.size = len(lst)
        tf.addfile(info, io.BytesIO(lst))
        for k, nme in enumerate(names):
            for sub, data in (
                    ("JPEGImages", _jpg_bytes(
                        np.full((6, 7, 3), 50 * (k + 1), np.uint8))),
                    ("SegmentationClass", _png_bytes(
                        np.full((6, 7), k, np.uint8)))):
                ext = ".jpg" if sub == "JPEGImages" else ".png"
                info = tarfile.TarInfo(f"VOCdevkit/VOC2012/{sub}/{nme}{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    j = JD.VOC2012(data_file=str(tmp_path / "voc.tar"), mode="train")
    t = TD.VOC2012(data_file=str(tmp_path / "voc.tar"), mode="train")
    assert len(t) == len(j) == 2
    for i in range(2):
        for a, b in zip(t[i], j[i]):
            _same(a, b)


def test_vision_namespace_and_image_backend(tmp_path):
    for name in ("RandomResizedCrop", "DatasetFolder", "mobilenet_v2",
                 "MNIST", "to_grayscale", "densenet121"):
        assert hasattr(TV, name) and hasattr(JV, name), name
    assert tpaddle.vision.transforms is TT
    assert TV.get_image_backend() == "numpy"
    TV.set_image_backend("pil")
    try:
        assert TV.get_image_backend() == "pil"
    finally:
        TV.set_image_backend("numpy")
    with pytest.raises(ValueError):
        TV.set_image_backend("tiff")
    arr = np.random.default_rng(8).integers(0, 256, (5, 6, 3),
                                            dtype=np.uint8)
    _png(tmp_path / "a.png", arr)
    np.testing.assert_array_equal(TV.image_load(str(tmp_path / "a.png")),
                                  arr)
