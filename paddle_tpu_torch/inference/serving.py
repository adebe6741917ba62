"""Batch serving (counterpart of paddle_tpu/inference/serving.py): the
future/queue server lifecycle (`_FutureQueueServer`, which `LLMServer`
also runs on) and the dynamic-batching `InferenceServer`.

    server = InferenceServer(model, BatchingConfig(max_batch_size=64))
    with server:
        y = server.submit(x_single).result()    # or server.infer(x)

Requests are single examples (no batch dim). One batcher thread owns
the device: it stacks up to `max_batch_size` queued requests (waiting at
most `max_delay_ms` for stragglers), pads the stack with copies of its
first row up to the next configured bucket, runs the model once under
`torch.inference_mode()` on its device, and scatters the rows back to
the requests' futures. The reference compiles one program per bucket;
here the buckets keep the batch shapes to the same few, eagerly.
"""
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

__all__ = ["BatchingConfig", "InferenceServer"]


class _FutureQueueServer:
    """ONE background thread owns the device; clients enqueue payloads
    (carrying a Future) from any thread. Subclasses implement `_loop`
    and a typed `submit` that calls `_enqueue`."""

    _thread_name = "serve-loop"

    def __init__(self):
        self._q = queue.Queue()
        self._thread = None
        self._running = False
        self._state_lock = threading.Lock()

    def start(self):
        if self._running:
            return self
        if self._thread is not None and self._thread.is_alive():
            # a previous stop() timed out: a second loop would consume the
            # same queue
            raise RuntimeError(
                "previous server thread is still shutting down; retry "
                "start() after it exits")
        self._running = True
        self._thread = threading.Thread(target=self._loop,
                                        name=self._thread_name, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        with self._state_lock:
            self._running = False
        if self._thread is not None:
            self._thread.join(timeout=30)
            if not self._thread.is_alive():
                self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def _enqueue(self, payload):
        # check + put under the lock: a put racing stop() would land in a
        # queue the loop has already drained
        with self._state_lock:
            if not self._running:
                raise RuntimeError("server not started (use `with server:`)")
            self._q.put(payload)

    def _loop(self):  # pragma: no cover - abstract
        raise NotImplementedError


class BatchingConfig:
    """Dynamic-batching policy: requests queue until `max_batch_size` are
    waiting or the oldest has waited `max_delay_ms`; the batch is padded
    up to the smallest bucket that fits (default: powers of two up to
    max_batch_size)."""

    def __init__(self, max_batch_size=32, max_delay_ms=2.0, buckets=None):
        self.max_batch_size = int(max_batch_size)
        self.max_delay_ms = float(max_delay_ms)
        if buckets is None:
            buckets = []
            b = 1
            while b < self.max_batch_size:
                buckets.append(b)
                b *= 2
            buckets.append(self.max_batch_size)
        self.buckets = sorted(set(int(b) for b in buckets))
        if self.buckets[-1] < self.max_batch_size:
            raise ValueError(
                f"largest bucket {self.buckets[-1]} < max_batch_size "
                f"{self.max_batch_size}")

    def bucket_for(self, n):
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]


def _host(out):
    """A model output as a host array (bf16 as f32: numpy has none)."""
    t = torch.as_tensor(out).detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _module_runner(module):
    """Run an nn.Module eagerly on its own device under inference mode;
    one call per padded batch."""
    module.eval()
    p = next(iter(module.parameters()), None)
    device = p.device if p is not None else torch.device("cpu")

    def run(arrs):
        with torch.inference_mode():
            out = module(*[torch.from_numpy(np.ascontiguousarray(a))
                           .to(device) for a in arrs])
        outs = out if isinstance(out, (list, tuple)) else (out,)
        return [_host(o) for o in outs]

    return run


class InferenceServer(_FutureQueueServer):
    """Dynamic-batching server over an nn.Module, a loaded `Predictor`
    (batches padded to its exported batch size) or a callable (module
    docstring). `submit` / `infer` are thread-safe; one background
    batcher thread owns the device."""

    _thread_name = "infer-batcher"

    def __init__(self, source, batching=None):
        super().__init__()
        # a private copy: a caller-shared config is never mutated
        src_cfg = batching or BatchingConfig()
        self.batching = BatchingConfig(
            max_batch_size=src_cfg.max_batch_size,
            max_delay_ms=src_cfg.max_delay_ms,
            buckets=list(src_cfg.buckets))
        if isinstance(source, torch.nn.Module):
            self._run = _module_runner(source)
        elif hasattr(source, "_layer") and hasattr(source, "run"):
            # a loaded artifact is shape-specialized: the only legal
            # bucket is its exported batch size, so every batch is
            # padded to it
            self._run = lambda arrs: source.run(list(arrs))
            specs = getattr(source._layer, "_input_specs", None)
            if specs:
                fixed = int(specs[0][0][0])
                self.batching.buckets = [fixed]
                self.batching.max_batch_size = min(
                    self.batching.max_batch_size, fixed)
        elif callable(source):
            def run(arrs):
                out = source(*arrs)
                outs = out if isinstance(out, (list, tuple)) else (out,)
                return [np.asarray(o) for o in outs]
            self._run = run
        else:
            raise TypeError(
                "InferenceServer source must be an nn.Module or a "
                f"callable; got {type(source)!r}")
        self.stats = {"requests": 0, "batches": 0, "rows_padded": 0}

    # -- client API --
    def submit(self, *example):
        """Enqueue ONE example (arrays without the batch dim). Returns a
        Future resolving to the list of this example's output rows."""
        fut = Future()
        self._enqueue((tuple(np.asarray(x) for x in example), fut))
        return fut

    def infer(self, *example):
        return self.submit(*example).result()

    @property
    def mean_batch_size(self):
        b = self.stats["batches"]
        return self.stats["requests"] / b if b else 0.0

    # -- batcher --
    def _collect(self):
        """Block for the first request, then take stragglers until the
        delay window closes or the batch is full."""
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.monotonic() + self.batching.max_delay_ms / 1e3
        while len(batch) < self.batching.max_batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    @staticmethod
    def _sig(example):
        return tuple((a.shape, str(a.dtype)) for a in example)

    def _loop(self):
        while self._running or not self._q.empty():
            collected = self._collect()
            if not collected:
                continue
            # one group per input signature: requests of other shapes
            # (or one malformed request) neither stack together nor fail
            # each other's futures
            groups = {}
            for ex, f in collected:
                groups.setdefault(self._sig(ex), []).append((ex, f))
            for batch in groups.values():
                try:
                    self._run_batch(batch)
                except Exception as e:  # never die silently
                    for _, f in batch:
                        if not f.done():
                            f.set_exception(e)

    def _run_batch(self, batch):
        examples = [ex for ex, _ in batch]
        futs = [f for _, f in batch]
        n = len(batch)
        bucket = self.batching.bucket_for(n)
        try:
            arrs = []
            for pos in range(len(examples[0])):
                rows = [ex[pos] for ex in examples]
                rows += [rows[0]] * (bucket - n)    # pad with row 0
                arrs.append(np.stack(rows))
            outs = self._run(arrs)
        except Exception as e:
            for f in futs:
                if not f.done():
                    f.set_exception(e)
            return
        self.stats["requests"] += n
        self.stats["batches"] += 1
        self.stats["rows_padded"] += bucket - n
        for i, f in enumerate(futs):
            f.set_result([o[i] for o in outs])
