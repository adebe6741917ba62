"""Observability (counterpart of paddle_tpu/observability): the port's
own metrics registry (`metrics`), span tracer (`tracing`), request
traces (`reqtrace`), failure flight recorder (`flight_recorder`) and
the training goodput plane (`steptrace`: phase traces of each
`TrainStep`, MFU / goodput gauges, the recompile sentinel). The telemetry mode comes
from ``PT_TELEMETRY`` (0 off, unset metrics, 1 full), as in the
reference; in full mode the process writes
``metrics.rank<r>.{prom,json}`` and ``trace.rank<r>.jsonl`` to
``PT_TELEMETRY_DIR`` (default ./telemetry) at exit (`export_all`) and
folds a compact snapshot into the anomaly journal
(distributed/resilience.py). `export_replica` writes one file per
in-process replica.

``start_http_server(port)`` serves the registry at ``/metrics``
(Prometheus text) and ``/metrics.json`` through the standard library's
ThreadingHTTPServer on 127.0.0.1: the pull endpoint behind
`LLMServer.start_metrics_http` and `FleetRouter.start_metrics_http`."""
import json
import os
import re
import threading

from . import flight_recorder, metrics, reqtrace, steptrace, tracing  # noqa: F401,E501
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,  # noqa: F401
                      _STATE, counter, gauge, histogram, registry,
                      snapshot, to_jsonl, to_prometheus)
from .reqtrace import TraceContext, new_trace  # noqa: F401
from .tracing import chrome_events, flush, trace_span  # noqa: F401

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "counter", "gauge", "histogram", "registry", "snapshot",
           "to_prometheus", "to_jsonl", "trace_span", "chrome_events",
           "flush", "set_mode", "mode", "metrics_enabled", "full_enabled",
           "export_all", "export_replica", "journal_snapshot",
           "bench_snapshot", "start_http_server", "telemetry_dir",
           "TraceContext", "new_trace", "reqtrace",
           "steptrace", "flight_recorder"]

_MODES = {"off": _STATE.OFF, "metrics": _STATE.METRICS,
          "full": _STATE.FULL}
_MODE_NAMES = {v: k for k, v in _MODES.items()}


def mode():
    """Current telemetry mode name: 'off' | 'metrics' | 'full'."""
    return _MODE_NAMES[_STATE.mode]


def set_mode(name):
    """Switch the telemetry mode at runtime ('off' | 'metrics' |
    'full'). Returns the previous mode name."""
    if name not in _MODES:
        raise ValueError(f"mode must be one of {sorted(_MODES)}")
    prev = mode()
    _STATE.mode = _MODES[name]
    if _STATE.mode == _STATE.FULL:
        _install_atexit()
    return prev


def metrics_enabled():
    return _STATE.mode >= _STATE.METRICS


def full_enabled():
    return _STATE.mode >= _STATE.FULL


def telemetry_dir():
    return os.environ.get("PT_TELEMETRY_DIR") or "./telemetry"


def _rank():
    return int(os.environ.get("PADDLE_TRAINER_ID", "0"))


def journal_snapshot(note=None):
    """Fold a compact registry snapshot into the per-rank anomaly
    journal as one ``telemetry_snapshot`` event (chaos runs and
    telemetry share that stream). Returns the journal entry."""
    from ..distributed.resilience import record

    fields = {"metrics": registry().compact()}
    if note:
        fields["note"] = note
    return record("telemetry_snapshot", **fields)


def bench_snapshot():
    """The registry's non-zero series as one compact dict, for stamping
    beside a benchmark's numbers."""
    return registry().compact()


def export_all(directory=None, journal=True):
    """Write metrics.rank<r>.prom + metrics.rank<r>.json and flush the
    span buffer to trace.rank<r>.jsonl under `directory` (default
    `telemetry_dir()`). Best-effort; returns the directory."""
    d = directory or telemetry_dir()
    r = _rank()
    try:
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"metrics.rank{r}.prom"), "w") as f:
            f.write(to_prometheus())
        with open(os.path.join(d, f"metrics.rank{r}.json"), "w") as f:
            json.dump(snapshot(), f, indent=1)
    except OSError:
        pass
    tracing.flush(d)
    if journal:
        try:
            journal_snapshot(note="export_all")
        except Exception:
            pass
    return d


def export_replica(name, view_fn=None, directory=None):
    """Per-replica telemetry file, `metrics.rank<r>.<name>.json`:
    threaded replicas share one process and one rank, so a file named by
    rank alone would leave only the last replica's view. `view_fn()`
    supplies the replica's own snapshot (the process registry rides
    along). Best-effort; returns the path or None."""
    d = directory or telemetry_dir()
    safe = re.sub(r"[^A-Za-z0-9_.-]", "_", str(name)) or "replica"
    path = os.path.join(d, f"metrics.rank{_rank()}.{safe}.json")
    payload = {"replica": str(name)}
    if view_fn is not None:
        try:
            payload["view"] = view_fn()
        except Exception as e:
            payload["view_error"] = repr(e)
    payload["metrics"] = registry().compact()
    try:
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, default=repr)
    except OSError:
        return None
    return path


_atexit_installed = False


def _install_atexit():
    global _atexit_installed
    if _atexit_installed:
        return
    _atexit_installed = True
    import atexit

    # the mode is read again at exit: a supervisor process drops itself
    # to 'metrics' so it never overwrites its children's files
    atexit.register(
        lambda: export_all() if _STATE.mode >= _STATE.FULL else None)


if _STATE.mode >= _STATE.FULL:
    _install_atexit()


class _HTTPHandle:
    """A running /metrics endpoint: .host, .port, .url; .stop() ends it
    and joins its thread."""

    def __init__(self, server, thread):
        self._server = server
        self._thread = thread
        self.host, self.port = server.server_address[:2]

    @property
    def url(self):
        return f"http://{self.host}:{self.port}/metrics"

    def stop(self):
        try:
            self._server.shutdown()
            self._server.server_close()
        except OSError:
            pass
        self._thread.join(timeout=5)


def start_http_server(port=0, host="127.0.0.1", extra_json=None):
    """Serve the port's registry over the standard library's HTTP
    server:

        GET /metrics       Prometheus text format
        GET /metrics.json  the registry snapshot (+ `extra_json()` under
                           "extra" when given)

    port=0 picks a free port. Returns an `_HTTPHandle` (stop() ends
    it)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/metrics":
                body = to_prometheus().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/metrics.json":
                payload = {"metrics": snapshot()}
                if extra_json is not None:
                    try:
                        payload["extra"] = extra_json()
                    except Exception as e:
                        payload["extra_error"] = repr(e)
                body = json.dumps(payload, default=repr).encode()
                ctype = "application/json"
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):        # no stderr line per scrape
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever,
                              name="pt-metrics-http", daemon=True)
    thread.start()
    return _HTTPHandle(server, thread)
