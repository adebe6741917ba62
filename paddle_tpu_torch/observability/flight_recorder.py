"""Failure flight recorder — bounded ring of recent telemetry +
self-contained postmortem dumps (counterpart of
paddle_tpu/observability/flight_recorder.py).

When a replica dies mid-stream, a failover requeues work or a chaos
injector fires, the question is what the system was doing in the
seconds before. The recorder keeps it: a bounded in-memory ring that
captures

* completed spans (full telemetry mode — fed by a `tracing` sink),
* request phase segments (`reqtrace`, metrics mode and up — so a
  killed request's timeline survives even without span tracing),
* router / scheduler events (shed, cancel, brownout, breaker, requeue)
  and the router monitor's throttled fleet view,

and :func:`dump` writes ONE self-contained postmortem JSON — reason,
caller context (dead replica, requeued request ids + trace_ids, ...),
the ring, the live state providers' snapshots and a compact metrics
dump. Wired into the failover path (`FleetRouter._handle_death`, the
chaos kill in `LocalReplica`) and `LLMEngine.abort_all`. The reference
also journals each dump into its anomaly journal, which the port does
not have: here a dump is counted (`pt_flight_dumps_total`) and written.

File policy: the ring and the counter are live in every telemetry mode
but off; the postmortem FILE is written when a directory is passed,
when ``PT_FLIGHT_DIR`` is set, or in full telemetry mode (to
``PT_TELEMETRY_DIR``) — so the default metrics mode never litters the
working directory with dump files.
"""
import collections
import json
import os
import threading
import time

from . import tracing
from .metrics import _STATE, counter, registry

__all__ = ["FlightRecorder", "recorder", "record_event", "dump",
           "add_state_provider", "remove_state_provider"]

_DUMPS_TOTAL = counter(
    "pt_flight_dumps_total",
    "flight-recorder postmortem dumps, by reason (replica_death | "
    "chaos_replica_kill | failover_requeue | divergence_rollback | "
    "engine_abort | manual)", labelnames=("reason",))


def _rank():
    return int(os.environ.get("PADDLE_TRAINER_ID", "0"))


class FlightRecorder:
    """Bounded event ring + postmortem writer (module docstring)."""

    def __init__(self, capacity=4096):
        self._ring = collections.deque(maxlen=int(capacity))
        self._providers = {}     # name -> zero-arg snapshot fn
        self._lock = threading.Lock()   # providers dict + dump seq
        self._seq = 0

    # ---- capture ----

    def record(self, kind, **fields):
        """Append one event (cheap: a dict build + deque append, both
        GIL-atomic; gated off in telemetry mode 'off')."""
        if _STATE.mode == 0:
            return
        entry = {"t": time.time(), "kind": kind}
        entry.update(fields)
        self._ring.append(entry)

    def events(self, kind=None):
        """Snapshot of the ring (oldest first)."""
        evs = list(self._ring)
        return evs if kind is None else [e for e in evs
                                         if e.get("kind") == kind]

    def clear(self):
        self._ring.clear()

    # ---- live-state providers (dump-time snapshots) ----

    def add_state_provider(self, name, fn):
        """Register a zero-arg snapshot callable (e.g. a router's
        `metrics`) included — individually guarded — in every dump."""
        with self._lock:
            self._providers[name] = fn

    def remove_state_provider(self, name):
        with self._lock:
            self._providers.pop(name, None)

    # ---- postmortem ----

    def dump(self, reason, directory=None, **context):
        """Write the postmortem (module docstring has the file policy).
        Always counts; returns the file path or None."""
        if _STATE.mode == 0:
            return None
        _DUMPS_TOTAL.labels(reason=reason).inc()
        with self._lock:
            providers = list(self._providers.items())
            seq = self._seq
            self._seq += 1
        states = {}
        for name, fn in providers:
            try:
                states[name] = fn()
            except Exception as e:   # a dying subsystem's snapshot
                states[name] = {"error": repr(e)}
        try:
            metrics_compact = registry().compact()
        except Exception as e:
            metrics_compact = {"error": repr(e)}
        payload = {"reason": reason, "t": time.time(), "rank": _rank(),
                   "context": context, "states": states,
                   "metrics": metrics_compact,
                   "events": list(self._ring)}
        d = directory or os.environ.get("PT_FLIGHT_DIR")
        if d is None and _STATE.mode >= _STATE.FULL:
            d = os.environ.get("PT_TELEMETRY_DIR") or "./telemetry"
        path = None
        if d:
            path = os.path.join(
                d, f"postmortem.rank{_rank()}.{seq}.{reason}.json")
            try:
                os.makedirs(d, exist_ok=True)
                with open(path, "w") as f:
                    # default=repr: context may carry numpy scalars /
                    # exceptions — a dump must never fail on its cargo
                    json.dump(payload, f, default=repr)
            except OSError:
                path = None
        return path


_RECORDER = FlightRecorder()


def recorder():
    """The process-wide default recorder."""
    return _RECORDER


def record_event(kind, **fields):
    _RECORDER.record(kind, **fields)


def dump(reason, directory=None, **context):
    return _RECORDER.dump(reason, directory=directory, **context)


def add_state_provider(name, fn):
    _RECORDER.add_state_provider(name, fn)


def remove_state_provider(name):
    _RECORDER.remove_state_provider(name)


def _span_sink(ev):
    # completed spans (full mode) flow into the ring so a postmortem
    # carries the last seconds of spans — incl. the per-request
    # phase.* events, which carry trace_id in their args
    _RECORDER.record("span", span=ev)


tracing.add_sink(_span_sink)
