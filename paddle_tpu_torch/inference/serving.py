"""Future/queue server lifecycle (counterpart of
paddle_tpu/inference/serving.py `_FutureQueueServer`)."""
import queue
import threading

__all__ = []


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
