"""Span tracer — chrome://tracing-compatible host-side spans
(counterpart of paddle_tpu/observability/tracing.py).

``trace_span("name", key=val)`` is a context manager AND a decorator.
In full-telemetry mode (``PT_TELEMETRY=1``) each span records one
complete ("ph": "X") chrome trace event: wall-clock ``ts`` (µs since the
unix epoch, so per-rank files from different processes align when
merged), monotonic ``dur``, ``pid`` = trainer rank, ``tid`` = thread id.
Below full mode entering a span is a single attribute check.

Composition with the device profiler: with ``PT_TRACE_ANNOTATE=1`` a
span also enters ``torch.profiler.record_function`` (where the
reference enters a jax TraceAnnotation), so the same scopes show up on
the CUDA timeline of a ``torch.profiler`` capture. Gated because the
annotation has a per-call cost even without an active capture.

Export: events buffer in memory (bounded; drops counted) and flush to
``<PT_TELEMETRY_DIR>/trace.rank<r>.jsonl`` — one JSON event per line,
the reference's file format.
"""
import json
import os
import threading
import time

from .metrics import _STATE, counter

__all__ = ["trace_span", "chrome_events", "flush", "reset",
           "trace_path", "MAX_EVENTS", "set_replica", "current_replica",
           "ambient_trace", "current_trace", "add_event", "add_sink",
           "remove_sink"]

MAX_EVENTS = int(os.environ.get("PT_TRACE_BUFFER", "200000"))

_events = []
_flush_lock = threading.Lock()
_flushed_paths = set()      # paths this PROCESS already wrote (see flush)
_dropped = counter("pt_trace_events_dropped_total",
                   "span events dropped by the bounded trace buffer")

# request-identity ambience (reqtrace.py is the user-facing surface).
# Thread-locals, because the serving runtime's unit of concurrency is
# the thread: a replica's serve loop tags every span it emits with its
# replica name, and a transport call made under `ambient_trace(ctx)`
# tags its spans with the request's trace_id — that is how one
# disaggregated request reads as a single causal chain across replica
# lanes and process boundaries in the merged timeline.
_tls = threading.local()

# event sinks: each completed event (span exit or add_event) is handed
# to every registered sink — the flight recorder's feed. Full mode
# only (below full, no events exist to feed).
_sinks = []


def set_replica(name):
    """Tag every span THIS thread emits with `replica` (a replica's
    serve loop calls this at start; None clears)."""
    _tls.replica = name


def current_replica():
    return getattr(_tls, "replica", None)


def current_trace():
    """The thread's ambient TraceContext (reqtrace), or None."""
    return getattr(_tls, "trace", None)


class ambient_trace:
    """Context manager: spans emitted by this thread inside the block
    carry `ctx.trace_id` (ctx None = no-op passthrough)."""

    __slots__ = ("_ctx", "_prev")

    def __init__(self, ctx):
        self._ctx = ctx

    def __enter__(self):
        self._prev = getattr(_tls, "trace", None)
        if self._ctx is not None:
            _tls.trace = self._ctx
        return self._ctx

    def __exit__(self, *exc):
        _tls.trace = self._prev
        return False


def add_sink(fn):
    """Register an event sink: fn(event_dict) on every completed span
    event (full mode). Sinks must be cheap and never raise."""
    if fn not in _sinks:
        _sinks.append(fn)


def remove_sink(fn):
    try:
        _sinks.remove(fn)
    except ValueError:
        pass


def _finish_event(ev):
    """Stamp ambient identity, buffer (bounded), feed sinks."""
    rep = getattr(_tls, "replica", None)
    if rep is not None:
        ev["replica"] = rep
    tr = getattr(_tls, "trace", None)
    if tr is not None:
        ev.setdefault("args", {}).setdefault("trace_id", tr.trace_id)
    if len(_events) >= MAX_EVENTS:
        _dropped.inc()
    else:
        _events.append(ev)      # list.append is atomic under the GIL
    for s in list(_sinks):
        try:
            s(ev)
        except Exception:
            pass


def _rank():
    return int(os.environ.get("PADDLE_TRAINER_ID", "0"))


def _annotate_enabled():
    return os.environ.get("PT_TRACE_ANNOTATE", "0") == "1"


class _Span:
    """One span use. Context manager (enter/exit records an event) and
    decorator (wraps fn; a fresh span per call)."""

    __slots__ = ("name", "args", "_t0", "_wall0", "_ann")

    def __init__(self, name, args):
        self.name = name
        self.args = args
        self._t0 = None
        self._ann = None

    def __enter__(self):
        if _STATE.mode < 2:
            return self
        self._wall0 = time.time()
        self._t0 = time.perf_counter()
        if _annotate_enabled():
            import torch

            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._ann is not None:
            self._ann.__exit__(exc_type, exc, tb)
            self._ann = None
        if self._t0 is None:
            return False
        dur_us = int((time.perf_counter() - self._t0) * 1e6)
        self._t0 = None
        ev = {"name": self.name, "ph": "X",
              "ts": int(self._wall0 * 1e6), "dur": dur_us,
              "pid": _rank(), "tid": threading.get_ident()}
        if self.args:
            # COPY: decorator usage shares one args dict across calls —
            # the error annotation below must not poison other events
            ev["args"] = dict(self.args)
        if exc_type is not None:
            ev.setdefault("args", {})["error"] = exc_type.__name__
        _finish_event(ev)
        return False

    def __call__(self, fn):
        import functools

        name, args = self.name, self.args

        @functools.wraps(fn)
        def wrapped(*a, **kw):
            with _Span(name, args):
                return fn(*a, **kw)

        return wrapped


def trace_span(name, **args):
    """Span factory: ``with trace_span("x", k=v): ...`` or
    ``@trace_span("x")``. No-op (one mode check) below full telemetry."""
    return _Span(name, args)


def add_event(name, ts_us, dur_us, args=None):
    """Record one pre-timed complete event (the reqtrace phase
    segments: their start is a stamp taken earlier, not a span entry on
    this thread). Full mode only; buffered/sunk like span exits."""
    if _STATE.mode < 2:
        return
    ev = {"name": name, "ph": "X", "ts": int(ts_us), "dur": int(dur_us),
          "pid": _rank(), "tid": threading.get_ident()}
    if args:
        ev["args"] = dict(args)
    _finish_event(ev)


def chrome_events():
    """Copy of the buffered chrome trace events (oldest first)."""
    return list(_events)


def trace_path(directory=None):
    d = directory or os.environ.get("PT_TELEMETRY_DIR") or "./telemetry"
    return os.path.join(d, f"trace.rank{_rank()}.jsonl")


def flush(directory=None):
    """Append buffered events to the per-rank trace JSONL and clear the
    buffer. Best-effort (exporting must never take the run down).
    Returns the path, or None when there was nothing to write."""
    with _flush_lock:
        if not _events:
            return None
        batch = _events[:]
        del _events[:len(batch)]
        path = trace_path(directory)
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            # first flush of THIS process truncates: successive runs
            # sharing PT_TELEMETRY_DIR must not concatenate into one
            # file, or trace_merge would fold distinct runs (hours
            # apart) onto a single rebased timeline
            fresh = path not in _flushed_paths
            _flushed_paths.add(path)
            with open(path, "w" if fresh else "a") as f:
                for ev in batch:
                    f.write(json.dumps(ev) + "\n")
        except OSError:
            return None
        return path


def reset():
    """Test hook: drop all buffered events."""
    del _events[:]
