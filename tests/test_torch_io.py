"""The data layer (paddle_tpu_torch/io, io/multiprocess.py, native) against
the JAX package's on the CPU.

* Samplers: under one `paddle.seed` (or one Generator seed) the port's
  shuffles, random_split, weighted and subset draws equal the
  reference's index for index — both seed numpy from the key stream's
  next key (`_np_rng`); DistributedBatchSampler's shards and
  BucketedBatchSampler's batches equal the reference's.
* `default_collate_fn` on nested samples: the same values and dtypes;
  the native assembler equal to `np.stack` (and built into `_build/`).
* Workers: thread and process workers (forkserver for a dataset that
  pickles, fork for one that does not) yield the batches of
  `num_workers=0`, in order, with deterministic transforms; a worker's
  exception reaches the caller with its type.
* Randomness (ROADMAP C): random transforms at `num_workers=0` draw the
  reference's augmentations under the same `random.seed` /
  `np.random.seed`; under workers neither package is reproducible (the
  reference's workers seed numpy by `base_seed + wid` and Python's
  `random` not at all, from a shared queue), so nothing holds them.

Nothing here waits on wall-clock timing; every loader with workers has
a `timeout`, so a stuck worker fails the test instead of hanging it.
"""
import os
import random

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import io as jio
from paddle_tpu.core import rng as jrng
from paddle_tpu.vision import transforms as JT
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import native as tnative
from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.vision import datasets as TD
from paddle_tpu_torch.vision import transforms as TT

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes at once, and torch's thread pool oversubscribes the
    cores then (small ops slow down tenfold); results do not change."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(getattr(x, "numpy", lambda: x)())


class _Range(tio.Dataset):
    def __init__(self, n):
        self.n = n

    def __getitem__(self, i):
        return np.full((3,), i, np.float32), i

    def __len__(self):
        return self.n


class _JRange(jio.Dataset):
    def __init__(self, n):
        self.n = n

    def __getitem__(self, i):
        return np.full((3,), i, np.float32), i

    def __len__(self):
        return self.n


# ---- samplers --------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 2024])
def test_shuffles_equal_the_reference_under_one_seed(seed):
    """Three epochs of a shuffled BatchSampler, then a RandomSampler with
    and without replacement, random_split, WeightedRandomSampler and
    SubsetRandomSampler, all drawing from the global key stream."""
    def draws(io, dataset):
        out = []
        bs = io.BatchSampler(dataset, shuffle=True, batch_size=4)
        for _ in range(3):
            out.append([list(b) for b in bs])
        out.append(list(io.RandomSampler(dataset)))
        out.append(list(io.RandomSampler(dataset, replacement=True,
                                         num_samples=9)))
        out.append([s.indices for s in io.random_split(dataset, [7, 6])])
        out.append(list(io.WeightedRandomSampler(
            np.arange(1.0, 14.0), 8)))
        out.append(list(io.SubsetRandomSampler([3, 5, 8, 11, 12])))
        return out

    paddle.seed(seed)
    want = draws(jio, _JRange(13))
    tpaddle.seed(seed)
    got = draws(tio, _Range(13))
    assert got == want


def test_generator_shuffles_equal_the_reference():
    want = list(jio.RandomSampler(_JRange(20),
                                  generator=jrng.Generator(11)))
    got = list(tio.RandomSampler(_Range(20), generator=trng.Generator(11)))
    assert got == want and sorted(got) == list(range(20))


@pytest.mark.parametrize("shuffle,drop_last", [(False, False),
                                               (True, False), (True, True)])
def test_distributed_batch_sampler_shards_equal_the_reference(shuffle,
                                                              drop_last):
    for rank in range(3):
        kw = dict(batch_size=4, num_replicas=3, rank=rank, shuffle=shuffle,
                  drop_last=drop_last)
        j = jio.DistributedBatchSampler(_JRange(23), **kw)
        t = tio.DistributedBatchSampler(_Range(23), **kw)
        for epoch in (0, 1):
            j.set_epoch(epoch)
            t.set_epoch(epoch)
            assert list(t) == list(j) and len(t) == len(j)


def test_bucketed_sampler_and_pad_collate_equal_the_reference():
    rng = np.random.default_rng(0)
    seqs = [rng.integers(1, 50, (int(n),)).astype(np.int64)
            for n in rng.integers(1, 40, 30)]
    samples = [(s, i % 3) for i, s in enumerate(seqs)]
    kw = dict(batch_size=4, lengths=[len(s) for s in seqs], shuffle=True)
    j = jio.BucketedBatchSampler(samples, **kw)
    t = tio.BucketedBatchSampler(samples, **kw)
    j.set_epoch(3)
    t.set_epoch(3)
    assert list(t) == list(j) and len(t) == len(j) and t.buckets == j.buckets
    jc = jio.pad_to_bucket_collate(j.buckets, pad_value=-1)
    tc = tio.pad_to_bucket_collate(t.buckets, pad_value=-1)
    for idx in list(t)[:4]:
        batch = [samples[i] for i in idx]
        for a, b in zip(tc(batch), jc(batch)):
            np.testing.assert_array_equal(_np(a), _np(b))


# ---- collate and the assembler --------------------------------------------

def test_default_collate_nested_samples_equal_the_reference():
    rng = np.random.default_rng(1)
    batch = [{"img": rng.standard_normal((2, 3)).astype(np.float32),
              "meta": (int(i), float(i) / 3, np.int64(i * 2)),
              "pair": [np.arange(4, dtype=np.int32) + i,
                       np.float32(i)]}
             for i in range(5)]
    want = jio.default_collate_fn(batch)
    got = tio.default_collate_fn(batch)

    def flat(x):
        if isinstance(x, dict):
            return [v for k in sorted(x) for v in flat(x[k])]
        if isinstance(x, (list, tuple)):
            return [v for e in x for v in flat(e)]
        return [x]

    fw, fg = flat(want), flat(got)
    assert len(fw) == len(fg) == 6
    for a, b in zip(fg, fw):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        assert _np(a).dtype == _np(b).dtype
        np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("shape,dtype", [((3, 5), np.float32),
                                         ((600, 700), np.uint8),
                                         ((), np.int64),
                                         ((4, 8, 9), np.float64)])
def test_assembler_equals_np_stack(shape, dtype):
    """Equal to np.stack, but for 0-d samples: both packages make them
    1-d first (`np.ascontiguousarray`), so a batch of scalar labels
    comes out [n, 1] — the reference's own result (its library is built
    here too), and paddle's label layout."""
    from paddle_tpu import native as jnative

    rng = np.random.default_rng(2)
    samples = [np.asarray(rng.standard_normal(shape) * 50).astype(dtype)
               for _ in range(6)]
    got = tnative.assemble_batch(samples)
    want = np.stack(samples)
    if not shape:
        want = want[:, None]
        np.testing.assert_array_equal(jnative.assemble_batch(samples), want)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.dtype(dtype)
    assert tnative.is_available()   # g++ is here: the library was built
    lib = tnative.get_lib()
    assert os.path.dirname(lib._name).endswith(os.path.join(
        "paddle_tpu_torch", "_build"))


def test_assembler_falls_back_to_np_stack_for_ragged_and_objects():
    ragged = [np.zeros((2,)), np.zeros((3,))]
    with pytest.raises(ValueError):
        tnative.assemble_batch(ragged)
    objs = [np.array([{"a": 1}], dtype=object)] * 2
    assert tnative.assemble_batch(objs).shape == (2, 1)


# ---- loaders and workers --------------------------------------------------

def _folder(tmp_path, n_classes=3, per_class=5, seed=0):
    rng = np.random.default_rng(seed)
    root = tmp_path / "folder"
    for c in range(n_classes):
        (root / f"c{c}").mkdir(parents=True)
        for i in range(per_class):
            h, w = rng.integers(40, 56, 2)
            np.save(root / f"c{c}" / f"{i}.npy",
                    rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    return str(root)


def _eval_transform(T):
    return T.Compose([T.Resize(40), T.CenterCrop(32),
                      T.Normalize([120.0, 110.0, 100.0], [60.0, 55.0, 50.0],
                                  data_format="HWC"),
                      T.Transpose()])


def _batches(loader):
    return [[_np(f).copy() for f in b] for b in loader]


def _assert_same(got, want):
    assert len(got) == len(want)
    for gb, wb in zip(got, want):
        for g, w in zip(gb, wb):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_folder_loader_at_zero_workers_equals_the_reference(tmp_path):
    from paddle_tpu.vision import datasets as JD

    root = _folder(tmp_path)
    jd = JD.DatasetFolder(root, loader=np.load, extensions=(".npy",),
                          transform=_eval_transform(JT))
    td = TD.DatasetFolder(root, loader=np.load, extensions=(".npy",),
                          transform=_eval_transform(TT))
    assert td.samples == jd.samples and td.classes == jd.classes
    want = _batches(jio.DataLoader(jd, batch_size=4))
    got = _batches(tio.DataLoader(td, batch_size=4))
    _assert_same(got, want)


@pytest.mark.parametrize("mode", ["forkserver", "fork", "thread"])
def test_workers_yield_the_batches_of_zero_workers(tmp_path, mode,
                                                   monkeypatch):
    """A picklable DatasetFolder goes to forkserver workers, the same
    dataset with an unpicklable transform to forked ones; the thread
    pool is `use_shared_memory=False`."""
    root = _folder(tmp_path)
    tf = _eval_transform(TT)
    if mode == "fork":
        inner = tf
        tf = lambda img: inner(img)  # noqa: E731  (does not pickle)
    ds = TD.DatasetFolder(root, loader=np.load, extensions=(".npy",),
                          transform=tf)
    want = _batches(tio.DataLoader(ds, batch_size=4))
    loader = tio.DataLoader(ds, batch_size=4, num_workers=3, timeout=120,
                            use_shared_memory=mode != "thread")
    if mode != "thread":
        from paddle_tpu_torch.io import multiprocess

        assert multiprocess._start_method(loader) == mode
    for _ in range(2):   # a second epoch starts a fresh pool
        _assert_same(_batches(loader), want)


class _Failing(tio.Dataset):
    def __getitem__(self, i):
        if i == 5:
            raise KeyError(f"sample {i}")
        return np.float32(i)

    def __len__(self):
        return 12


@pytest.mark.parametrize("mode", ["process", "thread"])
def test_a_worker_exception_reaches_the_caller_with_its_type(mode):
    loader = tio.DataLoader(_Failing(), batch_size=2, num_workers=2,
                            timeout=120,
                            use_shared_memory=mode == "process")
    got = []
    with pytest.raises(KeyError, match="sample 5"):
        for b in loader:
            got.append(_np(b).tolist())
    assert got == [[0.0, 1.0], [2.0, 3.0]]


class _Stream(tio.IterableDataset):
    def __init__(self, n):
        self.n = n

    def __iter__(self):
        for i in range(self.n):
            yield np.array([i, i * i], np.int64)


class _JStream(jio.IterableDataset):
    def __init__(self, n):
        self.n = n

    def __iter__(self):
        for i in range(self.n):
            yield np.array([i, i * i], np.int64)


@pytest.mark.parametrize("drop_last", [False, True])
def test_iterable_dataset_equals_the_reference(drop_last):
    want = [_np(b) for b in jio.DataLoader(_JStream(10), batch_size=4,
                                           drop_last=drop_last)]
    got = [_np(b) for b in tio.DataLoader(_Stream(10), batch_size=4,
                                          drop_last=drop_last)]
    assert len(got) == len(want) == (2 if drop_last else 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(TypeError):
        len(tio.DataLoader(_Stream(3)))


def test_chain_compose_subset_and_tensor_datasets():
    a, b = _Range(4), _Range(3)
    comp = tio.ComposeDataset([a, b])
    assert len(comp) == 3 and comp[2][1] == 2 and len(comp[2]) == 4
    chain = [x for x in tio.ChainDataset([_Stream(2), _Stream(3)])]
    assert [int(x[0]) for x in chain] == [0, 1, 0, 1, 2]
    sub = tio.Subset(a, [3, 1])
    assert len(sub) == 2 and sub[0][1] == 3
    td = tio.TensorDataset([torch.arange(6).reshape(3, 2),
                            torch.arange(3)])
    x, y = tio.default_collate_fn([td[i] for i in range(3)])
    assert x.shape == (3, 2) and y.tolist() == [0, 1, 2]


def test_worker_info_in_thread_workers():
    seen = []

    class _Who(tio.Dataset):
        def __getitem__(self, i):
            info = tio.get_worker_info()
            seen.append((info.id, info.num_workers))
            return np.float32(i)

        def __len__(self):
            return 8

    assert tio.get_worker_info() is None
    out = [_np(b).tolist() for b in tio.DataLoader(
        _Who(), batch_size=2, num_workers=2, use_shared_memory=False)]
    assert out == [[0.0, 1.0], [2.0, 3.0], [4.0, 5.0], [6.0, 7.0]]
    assert {n for _, n in seen} == {2} and {i for i, _ in seen} <= {0, 1}


def test_random_transforms_at_zero_workers_equal_the_reference(tmp_path):
    """The training transform of chip_smoke 14 (b) at a small side: the
    same `random.seed` / `np.random.seed` draw the same crops and flips
    in both packages."""
    from paddle_tpu.vision import datasets as JD

    root = _folder(tmp_path, per_class=4)

    def train_tf(T):
        return T.Compose([T.RandomResizedCrop(24), T.RandomHorizontalFlip(),
                          T.Normalize([0.0] * 3, [255.0] * 3,
                                      data_format="HWC"),
                          T.Transpose()])

    out = []
    for D, T, io in ((JD, JT, jio), (TD, TT, tio)):
        ds = D.DatasetFolder(root, loader=np.load, extensions=(".npy",),
                             transform=train_tf(T))
        random.seed(5)
        np.random.seed(5)
        out.append(_batches(io.DataLoader(ds, batch_size=3)))
    _assert_same(out[1], out[0])
