"""Datasets, samplers and the DataLoader (counterpart of paddle_tpu/io,
reference python/paddle/io).

Batches come out as CPU torch tensors; `hapi.Model` and `jit.TrainStep`
move them to the network's device. Three ways to iterate, each in the
sampler's order:

* `num_workers == 0`: the samples are read and collated in the caller.
* `num_workers > 0` (the default path): worker PROCESSES
  (`io/multiprocess.py`) collate each batch and hand it over through a
  shared-memory segment; Python-heavy transforms hold the GIL, so threads
  cannot scale ImageNet-style augmentation.
* `use_shared_memory=False`: a thread pool in this process (`_PrefetchIter`)
  with a bounded queue, for collate-only pipelines and datasets that
  cannot cross a process boundary.

Shuffles draw their numpy seed from the framework's key stream
(`core.rng.next_key`, the reference's `_np_rng`), so under one
`paddle.seed` the port shuffles in the reference's order, index for
index.
"""
import itertools
import math
import queue as queue_mod
import threading

import numpy as np
import torch

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "ChainDataset",
    "ComposeDataset", "Subset", "random_split",
    "Sampler", "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
    "SubsetRandomSampler",
    "BatchSampler", "DistributedBatchSampler", "BucketedBatchSampler",
    "DataLoader", "default_collate_fn", "pad_to_bucket_collate",
    "get_worker_info",
]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (list, tuple)) else [item])
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    if sum(lengths) != len(dataset):
        raise ValueError("sum of lengths must equal dataset length")
    perm = _np_rng(generator).permutation(len(dataset))
    out, offset = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset: offset + n].tolist()))
        offset += n
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


def _np_rng(generator):
    """A numpy RandomState seeded from the next key of `generator` (a
    `core.rng.Generator`) or of the framework's global stream, so
    `paddle.seed` controls shuffling: the key's last word, as the
    reference takes it."""
    if generator is not None and hasattr(generator, "next_key"):
        key = generator.next_key()
    else:
        from ..core import rng as core_rng

        key = core_rng.next_key()
    seed = int(np.asarray(key.cpu() if isinstance(key, torch.Tensor)
                          else key)[-1]) & 0x7FFFFFFF
    return np.random.RandomState(seed)


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self._num_samples is not None and self._num_samples > n and \
                not self.replacement:
            raise ValueError(
                f"num_samples={self._num_samples} > dataset size {n} "
                "requires replacement=True")
        rng = _np_rng(self.generator)
        if self.replacement:
            return iter(rng.randint(0, n, self.num_samples).tolist())
        return iter(rng.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True,
                 generator=None):
        # a copy: a caller's array mutated mid-training would skew draws
        self.weights = np.array(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement
        self.generator = generator

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = _np_rng(self.generator).choice(
            len(self.weights), self.num_samples,
            replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    """Shuffled draw from a fixed index subset."""

    def __init__(self, indices, generator=None):
        super().__init__(None)
        self.indices = list(indices)
        self.generator = generator

    def __iter__(self):
        order = _np_rng(self.generator).permutation(len(self.indices))
        return iter(self.indices[i] for i in order)

    def __len__(self):
        return len(self.indices)


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        if sampler is None:
            sampler = (RandomSampler(dataset) if shuffle
                       else SequenceSampler(dataset))
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class BucketedBatchSampler(BatchSampler):
    """Length-bucketed batching for variable-length data: samples are
    grouped into length buckets and each batch is padded to its bucket
    (pair with `pad_to_bucket_collate`), so a run sees at most
    `len(buckets)` batch shapes.

    lengths: per-sample lengths, a sequence or a callable applied to each
    element. buckets: ascending boundaries (default: powers of two from 8
    up to the longest sample); longer samples go into the last bucket and
    the collate pads them to their own length. shuffle: within buckets
    and over the batch order, seeded by `set_epoch`."""

    def __init__(self, dataset, batch_size, lengths=None, buckets=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        if lengths is None:
            lengths = [len(dataset[i]) for i in range(len(dataset))]
        elif callable(lengths):
            lengths = [lengths(dataset[i]) for i in range(len(dataset))]
        self.lengths = [int(x) for x in lengths]
        if buckets is None:
            top = max(self.lengths) if self.lengths else 8
            buckets, b = [], 8
            while b < top:
                buckets.append(b)
                b *= 2
            buckets.append(max(b, top))
        self.buckets = sorted(set(int(b) for b in buckets))

    def bucket_for(self, n):
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        rng = np.random.RandomState(self.epoch)
        by_bucket = {}
        for idx, n in enumerate(self.lengths):
            by_bucket.setdefault(self.bucket_for(n), []).append(idx)
        batches = []
        for b in self.buckets:
            idxs = by_bucket.get(b, [])
            if self.shuffle:
                idxs = [idxs[i] for i in rng.permutation(len(idxs))]
            for k in range(0, len(idxs), self.batch_size):
                chunk = idxs[k:k + self.batch_size]
                if len(chunk) < self.batch_size and self.drop_last:
                    continue
                batches.append(chunk)
        if self.shuffle:
            batches = [batches[i] for i in rng.permutation(len(batches))]
        return iter(batches)

    def __len__(self):
        by_bucket = {}
        for n in self.lengths:
            by_bucket[self.bucket_for(n)] = \
                by_bucket.get(self.bucket_for(n), 0) + 1
        total = 0
        for c in by_bucket.values():
            total += (c // self.batch_size if self.drop_last
                      else (c + self.batch_size - 1) // self.batch_size)
        return total


def _host_array(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def pad_to_bucket_collate(buckets, pad_value=0, with_length=True):
    """Collate-fn factory for ragged samples: every array field whose
    leading dimension varies is padded with `pad_value` to the smallest
    bucket ≥ the batch's longest sample. Samples may be arrays or tuples
    of (array-like, scalar label, ...) fields. With `with_length` the
    batch gains a trailing int32 lengths tensor, the mask the loss
    needs."""
    buckets = sorted(set(int(b) for b in buckets))

    def bucket_for(n):
        for b in buckets:
            if b >= n:
                return b
        return n   # longer than every bucket: pad to the sample

    def collate(batch):
        first = batch[0]
        tuple_mode = isinstance(first, (tuple, list))
        fields = (list(zip(*batch)) if tuple_mode else [list(batch)])
        out = []
        lengths = None
        for col in fields:
            col = [_host_array(x) for x in col]
            if col[0].ndim:
                # an array field is always padded to its bucket: one
                # shape per bucket
                lens = [c.shape[0] for c in col]
                width = bucket_for(max(lens))
                padded = np.full((len(col), width) + col[0].shape[1:],
                                 pad_value, col[0].dtype)
                for i, c in enumerate(col):
                    padded[i, : c.shape[0]] = c
                out.append(torch.from_numpy(padded))
                if lengths is None:
                    lengths = np.asarray(lens, np.int32)
            else:
                out.append(torch.from_numpy(np.stack(col)))
        if with_length:
            if lengths is None:
                lengths = np.zeros((len(batch),), np.int32)
            out.append(torch.from_numpy(lengths))
        return out[0] if (not tuple_mode and not with_length) \
            else tuple(out)

    return collate


class DistributedBatchSampler(BatchSampler):
    """Rank-sharded batch sampler (reference:
    python/paddle/fluid/dataloader/batch_sampler.py)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None or rank is None:
            from ..distributed import env as dist_env

            num_replicas = num_replicas or dist_env.get_world_size()
            rank = rank if rank is not None else dist_env.get_rank()
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))
        # pad (repeating as often as needed): every rank must see the same
        # number of batches or the ranks' collectives deadlock
        while len(indices) < self.total_size:
            indices += indices[: self.total_size - len(indices)]
        indices = indices[self.local_rank: self.total_size: self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size


def default_collate_fn(batch):
    """Stack samples into CPU tensors, field by field (reference:
    python/paddle/fluid/dataloader/collate.py). numpy samples go through
    the native assembler (`native.assemble_batch`: a GIL-released
    parallel memcpy, `np.stack` without the library)."""
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        from .. import native

        return torch.from_numpy(native.assemble_batch(batch))
    if isinstance(sample, (int, float, np.floating, np.integer)):
        return torch.from_numpy(np.asarray(batch))
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, (list, tuple)):
        return tuple(default_collate_fn(list(col)) for col in zip(*batch))
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    raise TypeError(f"cannot collate {type(sample)}")


class _WorkerInfo:
    def __init__(self, id_, num_workers, dataset):
        self.id = id_
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info = threading.local()


def get_worker_info():
    return getattr(_worker_info, "info", None)


class _IterState:
    """Worker-shared state. Holds NO reference to the consumer iterator so
    the iterator can be garbage-collected while workers run; a weakref
    finalizer flips `stop` when the consumer goes away."""

    __slots__ = ("queue", "work_q", "stop", "done_lock", "done_workers",
                 "n_workers", "dataset", "collate", "worker_init_fn")


_SENTINEL = object()


def _prefetch_feed(state, index_iter):
    seq = 0
    err = None
    try:
        for idx_batch in index_iter:
            if state.stop.is_set():
                break
            state.work_q.put((seq, idx_batch))
            seq += 1
    except Exception as e:  # a sampler's error reaches the consumer
        err = e
    finally:
        if err is not None:
            _put_stoppable(state, (seq, None, err))
            seq += 1
        for _ in range(state.n_workers):
            state.work_q.put(None)


def _put_stoppable(state, item):
    """Bounded put that bails out if the consumer abandoned us."""
    while not state.stop.is_set():
        try:
            state.queue.put(item, timeout=0.1)
            return True
        except queue_mod.Full:
            continue
    return False


def _worker_done(state):
    with state.done_lock:
        state.done_workers += 1
        if state.done_workers == state.n_workers:
            _put_stoppable(state, _SENTINEL)


def _prefetch_work(state, wid):
    _worker_info.info = _WorkerInfo(wid, state.n_workers, state.dataset)
    if state.worker_init_fn is not None:
        try:
            state.worker_init_fn(wid)
        except Exception as e:
            _put_stoppable(state, (-1, None, e))
            _worker_done(state)
            return  # no batches from an uninitialized worker
    while not state.stop.is_set():
        item = state.work_q.get()
        if item is None:
            break
        seq, idx_batch = item
        try:
            samples = [state.dataset[i] for i in idx_batch]
            out = (seq, state.collate(samples), None)
        except Exception as e:  # propagate to the consumer
            out = (seq, None, e)
        if not _put_stoppable(state, out):
            break
    _worker_done(state)


class _PrefetchIter:
    """Background-thread batch assembly with a bounded queue; the single
    consumer reorders out-of-order worker results."""

    def __init__(self, loader, index_iter):
        import weakref

        state = _IterState()
        state.n_workers = max(1, loader.num_workers)
        depth = max(2, loader.prefetch_factor * state.n_workers)
        state.queue = queue_mod.Queue(maxsize=depth)
        state.work_q = queue_mod.Queue()
        state.stop = threading.Event()
        state.done_lock = threading.Lock()
        state.done_workers = 0
        state.dataset = loader.dataset
        state.collate = loader.collate_fn
        state.worker_init_fn = getattr(loader, "worker_init_fn", None)
        self._state = state
        self._reorder = {}
        self._next_emit = 0
        self._sentinel_seen = False
        # when the consumer is dropped, stop the pool (threads only
        # reference `state`, never `self`)
        self._finalizer = weakref.finalize(self, state.stop.set)
        threading.Thread(target=_prefetch_feed, args=(state, index_iter),
                         daemon=True).start()
        for i in range(state.n_workers):
            threading.Thread(target=_prefetch_work, args=(state, i),
                             daemon=True).start()

    def __next__(self):
        while True:
            if self._next_emit in self._reorder:
                _, batch, err = self._reorder.pop(self._next_emit)
                self._next_emit += 1
                if err is not None:
                    self._state.stop.set()
                    raise err
                return batch
            if self._sentinel_seen and not self._reorder:
                raise StopIteration
            item = self._state.queue.get()
            if item is _SENTINEL:
                self._sentinel_seen = True
                continue
            if item[0] == -1:  # worker_init_fn failure: fail fast
                self._state.stop.set()
                raise item[2]
            self._reorder[item[0]] = item

    def __iter__(self):
        return self


class DataLoader:
    """(reference: python/paddle/io DataLoader → fluid/reader.py:326)."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.use_shared_memory = use_shared_memory
        self.worker_init_fn = worker_init_fn
        self.timeout = timeout
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no fixed length")
        return len(self.batch_sampler)

    def _iter_iterable(self):
        it = iter(self.dataset)
        while True:
            batch = list(itertools.islice(it, self.batch_size))
            if not batch:
                return
            if len(batch) < self.batch_size and self.drop_last:
                return
            yield self.collate_fn(batch)

    def __iter__(self):
        if self._iterable_mode:
            return self._iter_iterable()
        if self.num_workers == 0:
            return self._iter_sync()
        from .multiprocess import MPPrefetchIter, can_fork

        if self.use_shared_memory and can_fork():
            return MPPrefetchIter(self, iter(self.batch_sampler))
        return _PrefetchIter(self, iter(self.batch_sampler))

    def _iter_sync(self):
        for idx_batch in self.batch_sampler:
            yield self.collate_fn([self.dataset[i] for i in idx_batch])
