"""The DataLoader's worker processes, batches in shared memory
(counterpart of paddle_tpu/io/multiprocess.py; reference
python/paddle/fluid/dataloader/dataloader_iter.py:342, worker.py).

* Start method: forkserver when the dataset, collate_fn and
  worker_init_fn pickle, else fork (PADDLE_TPU_MP_START overrides). The
  forkserver preloads this module, so it imports torch and the port once
  and each worker forks from it ready; importing the port initialises no
  CUDA and builds nothing. A forked child of a process that holds a CUDA
  context must never touch CUDA: the workers collate to CPU tensors and
  run with one intra-op thread.
* A worker collates one batch and packs its arrays into ONE
  `multiprocessing.shared_memory` segment; only the structure goes
  through the result queue. The parent copies the arrays out, unlinks
  the segment and makes the CPU tensors.
* The parent reorders results by sequence number, so the batch order is
  the sampler's whatever the workers' scheduling.
* Randomness, as the reference's code: each worker seeds numpy with
  `base_seed + wid` (`base_seed` from the parent's numpy stream) and
  Python's `random` not at all, and the work queue is shared, so which
  worker's stream a batch meets depends on scheduling (ROADMAP C).
"""
import multiprocessing as mp
import os
import queue as queue_mod
import threading
import traceback
import weakref

import numpy as np
import torch

__all__ = ["MPPrefetchIter", "can_fork"]


def _picklable(*objs):
    import pickle

    try:
        for o in objs:
            pickle.dumps(o)
        return True
    except Exception:
        return False


def _start_method(loader):
    """forkserver when the workers' inputs pickle, else fork;
    PADDLE_TPU_MP_START overrides. Memoized on the loader: the probe
    pickles the whole dataset."""
    m = os.environ.get("PADDLE_TPU_MP_START")
    if m:
        return m
    cached = getattr(loader, "_mp_start_method", None)
    if cached is None:
        cached = ("forkserver" if _picklable(
            loader.dataset, loader.collate_fn,
            getattr(loader, "worker_init_fn", None)) else "fork")
        try:
            loader._mp_start_method = cached
        except AttributeError:
            pass
    return cached


_DONE = "__worker_done__"
_WORKER_FAIL = "__worker_fail__"


def can_fork():
    return hasattr(os, "fork") and os.name == "posix"


# arrays ride shared memory, the structure and scalars ride the queue

def _encode(obj, leaves):
    if isinstance(obj, torch.Tensor):
        leaves.append(np.ascontiguousarray(obj.detach().cpu().numpy()))
        return ("T", len(leaves) - 1)
    if isinstance(obj, np.ndarray):
        leaves.append(np.ascontiguousarray(obj))
        return ("A", len(leaves) - 1)
    if isinstance(obj, tuple):
        return ("t", [_encode(o, leaves) for o in obj])
    if isinstance(obj, list):
        return ("l", [_encode(o, leaves) for o in obj])
    if isinstance(obj, dict):
        return ("d", {k: _encode(v, leaves) for k, v in obj.items()})
    return ("o", obj)  # scalar / string / anything picklable


def _decode(spec, arrays):
    kind, payload = spec
    if kind == "T":
        return torch.from_numpy(arrays[payload])
    if kind == "A":
        return arrays[payload]  # already copied out of the segment
    if kind == "t":
        return tuple(_decode(s, arrays) for s in payload)
    if kind == "l":
        return [_decode(s, arrays) for s in payload]
    if kind == "d":
        return {k: _decode(s, arrays) for k, s in payload.items()}
    return payload


def _ship(seq, batch):
    """Worker side: pack a collated batch into one shm segment; returns
    the result-queue message (seq, (spec, metas, shm_name), None)."""
    from multiprocessing import shared_memory

    leaves = []
    spec = _encode(batch, leaves)
    total = sum(a.nbytes for a in leaves)
    if total == 0:
        return (seq, (spec, [], None), None)
    shm = shared_memory.SharedMemory(create=True, size=total)
    metas, off = [], 0
    for a in leaves:
        np.frombuffer(shm.buf, np.uint8, a.nbytes, off)[:] = \
            a.reshape(-1).view(np.uint8)
        metas.append((off, a.shape, a.dtype.str))
        off += a.nbytes
    name = shm.name
    shm.close()
    # the parent unlinks after consuming; unregister here so this
    # process's resource tracker does not warn about a segment it no
    # longer owns
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister("/" + name, "shared_memory")
    except Exception:  # the entry may already be gone
        pass
    return (seq, (spec, metas, name), None)


def _receive(payload):
    """Parent side: materialize the batch and release the segment."""
    from multiprocessing import shared_memory

    spec, metas, name = payload
    if name is None:
        return _decode(spec, [])
    shm = shared_memory.SharedMemory(name=name)
    try:
        # copy out: views over shm.buf must all be gone before close()
        arrays = []
        for off, shape, dt in metas:
            view = np.frombuffer(
                shm.buf, dtype=np.dtype(dt),
                count=int(np.prod(shape, dtype=np.int64)),
                offset=off).reshape(shape)
            arrays.append(np.array(view))
            del view
        return _decode(spec, arrays)
    finally:
        shm.close()
        try:
            shm.unlink()
        except FileNotFoundError:
            pass


def _drop(payload):
    """Parent side: unlink a segment whose batch will never be consumed."""
    from multiprocessing import shared_memory

    if payload and payload[2] is not None:
        try:
            shm = shared_memory.SharedMemory(name=payload[2])
            shm.close()
            shm.unlink()
        except FileNotFoundError:
            pass


def _worker_loop(wid, n_workers, dataset, collate, work_q, result_q, stop,
                 worker_init_fn, base_seed):
    # a numpy stream a worker: forked children otherwise share the
    # parent's global state and draw identical augmentations
    np.random.seed((base_seed + wid) & 0x7FFFFFFF)
    # one intra-op thread: a forked child must not use the parent's
    # OpenMP pool, and N workers × N threads oversubscribe the host
    torch.set_num_threads(1)
    from . import _WorkerInfo, _worker_info

    _worker_info.info = _WorkerInfo(wid, n_workers, dataset)
    try:
        if worker_init_fn is not None:
            worker_init_fn(wid)
    except Exception:
        result_q.put((_WORKER_FAIL, traceback.format_exc()))
        return
    try:
        while not stop.is_set():
            try:
                item = work_q.get(timeout=0.5)
            except queue_mod.Empty:
                continue
            if item is None:
                break
            seq, idx_batch = item
            try:
                samples = [dataset[i] for i in idx_batch]
                msg = _ship(seq, collate(samples))
            except Exception as e:
                # the exception OBJECT, so the parent re-raises its type;
                # the traceback text when it does not pickle
                import pickle

                tb = traceback.format_exc()
                try:
                    pickle.dumps(e)
                except Exception:
                    e = None
                msg = (seq, None, (e, tb))
            result_q.put(msg)
    finally:
        result_q.put((_DONE, wid))


class _MPState:
    """Everything the finalizer needs — deliberately no reference back to
    the iterator, so abandoning the iterator tears the pool down."""

    __slots__ = ("work_q", "result_q", "stop", "procs", "feeder")


def _shutdown(state):
    state.stop.set()
    # unblock workers waiting on work_q, then drain any shm still in flight
    for _ in state.procs:
        try:
            state.work_q.put_nowait(None)
        except queue_mod.Full:
            pass   # a full queue wakes the workers anyway
    for p in state.procs:
        p.join(timeout=5.0)
    # drain with a short timeout: exiting workers may still be flushing
    # through the queue's feeder pipe, and a get_nowait would race it and
    # leak the segments of batches in flight
    quiet = 0
    for _ in range(512):
        try:
            msg = state.result_q.get(timeout=0.2)
        except (queue_mod.Empty, OSError):
            quiet += 1
            if quiet >= 2 or any(p.is_alive() for p in state.procs):
                break
            continue
        if msg and msg[0] not in (_DONE, _WORKER_FAIL) and msg[1]:
            _drop(msg[1])
    for p in state.procs:
        if p.is_alive():
            p.terminate()
            p.join(timeout=2.0)


def _feed(state, index_iter, n_workers):
    seq = 0
    err = None
    try:
        for idx_batch in index_iter:
            if state.stop.is_set():
                return
            while not state.stop.is_set():
                try:
                    state.work_q.put((seq, list(idx_batch)), timeout=0.1)
                    break
                except queue_mod.Full:
                    continue
            seq += 1
    except Exception:
        err = traceback.format_exc()
    finally:
        if err is not None and not state.stop.is_set():
            state.result_q.put((seq, None, err))
        for _ in range(n_workers):
            while not state.stop.is_set():
                try:
                    state.work_q.put(None, timeout=0.1)
                    break
                except queue_mod.Full:
                    continue


def _context(method):
    ctx = mp.get_context(method)
    if method == "forkserver":
        # the server imports torch and the port once; a no-op once the
        # server runs
        ctx.set_forkserver_preload([__name__])
    return ctx


class MPPrefetchIter:
    """Multi-process DataLoader iterator: worker processes, shared-memory
    transport, sequence-number reordering, bounded in-flight depth."""

    def __init__(self, loader, index_iter):
        from .. import native

        # build the assembler here, once, not in every worker at once
        native.get_lib()
        ctx = _context(_start_method(loader))
        n = loader.num_workers
        depth = max(2, loader.prefetch_factor * n)
        state = _MPState()
        state.stop = ctx.Event()
        state.work_q = ctx.Queue(maxsize=depth)
        state.result_q = ctx.Queue()
        # from the parent's (seedable) numpy stream: identically seeded
        # runs draw the same worker seeds
        base_seed = int(np.random.randint(0, 2 ** 31 - 1))
        state.procs = [
            ctx.Process(
                target=_worker_loop,
                args=(i, n, loader.dataset, loader.collate_fn, state.work_q,
                      state.result_q, state.stop,
                      getattr(loader, "worker_init_fn", None), base_seed),
                daemon=True)
            for i in range(n)
        ]
        for p in state.procs:
            p.start()
        self._state = state
        self._n_workers = n
        self._timeout = getattr(loader, "timeout", 0) or None
        self._reorder = {}
        self._next_emit = 0
        self._done_workers = 0
        self._finalizer = weakref.finalize(self, _shutdown, state)
        state.feeder = threading.Thread(
            target=_feed, args=(state, index_iter, n), daemon=True)
        state.feeder.start()

    def __iter__(self):
        return self

    def __next__(self):
        state = self._state
        while True:
            if self._next_emit in self._reorder:
                payload, err = self._reorder.pop(self._next_emit)
                self._next_emit += 1
                if err is not None:
                    exc, tb = err if isinstance(err, tuple) else (None, err)
                    self._finalizer()
                    if exc is not None:
                        raise exc  # its own type, as on the thread path
                    raise RuntimeError(
                        f"DataLoader worker failed on batch "
                        f"{self._next_emit - 1}:\n{tb}")
                return _receive(payload)
            if self._done_workers == self._n_workers:
                if self._reorder:
                    # the workers exited with gaps in the sequence: one
                    # died (e.g. OOM-killed) without reporting its batch
                    for payload, _ in self._reorder.values():
                        _drop(payload)
                    self._reorder.clear()
                    self._fail("DataLoader worker exited before producing "
                               f"batch {self._next_emit}")
                self._finalizer()
                raise StopIteration
            try:
                msg = state.result_q.get(timeout=self._timeout or 5.0)
            except queue_mod.Empty:
                if self._timeout:
                    self._fail(
                        f"DataLoader timed out after {self._timeout}s "
                        f"waiting for batch {self._next_emit}")
                if not any(p.is_alive() for p in state.procs):
                    # every worker is gone without a full set of _DONEs:
                    # fail rather than poll forever
                    self._fail("DataLoader workers died unexpectedly")
                continue
            if msg[0] == _DONE:
                self._done_workers += 1
            elif msg[0] == _WORKER_FAIL:
                self._fail(f"worker_init_fn failed:\n{msg[1]}")
            else:
                self._reorder[msg[0]] = (msg[1], msg[2])

    def _fail(self, text):
        err = RuntimeError(text)
        self._finalizer()  # tear down before raising — no orphan pool
        raise err
