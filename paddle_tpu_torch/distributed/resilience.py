"""The anomaly journal (counterpart of the journal half of
paddle_tpu/distributed/resilience.py).

Every anomaly of the serving fleet — a KV-tier spill that failed to
commit, a disk frame garbage-collected at restart, a telemetry snapshot
— lands in one per-rank JSONL journal
(``$PADDLE_LOG_DIR/anomalies.rank<r>.jsonl``; ``$PT_ANOMALY_DIR``
overrides the directory) and in an in-memory ring of the last 256
events, so tests and post-mortems read the same stream without touching
disk. The file format is the reference's, line for line. Each event is
also mirrored into the flight recorder's ring and counted in
``pt_journal_events_total{kind}`` on the port's registry.

The retry policy, the step guard, the divergence sentinel and the
preemption handler harden the distributed training stack, which is not
ported yet: they raise, naming ROADMAP A11.
"""
import collections
import json
import os
import threading
import time

from ..observability import metrics as _obs

__all__ = ["AnomalyJournal", "record", "events", "recent_failures",
           "reset", "RetryPolicy", "StepGuard", "DivergenceSentinel",
           "PreemptionHandler", "install_preemption_handler"]

_JOURNAL_EVENTS = _obs.counter(
    "pt_journal_events_total", "anomaly-journal events, by kind",
    labelnames=("kind",))

# retry events of the last minutes: (t_monotonic, op name). Nothing in
# the port retries yet (the transports are A11), so the window stays
# empty; the heartbeat's degraded-rank signal reads it all the same
_recent = collections.deque(maxlen=512)
_recent_lock = threading.Lock()


def recent_failures(window_s=30.0):
    """Retry events observed in the last `window_s` seconds — the
    degraded-rank signal (a rank that beats but retry-storms is
    degraded, not dead)."""
    cut = time.monotonic() - window_s
    with _recent_lock:
        return sum(1 for t, _ in _recent if t >= cut)


class AnomalyJournal:
    """Append-only JSONL journal, one file per rank. Disk writes are
    best-effort (journaling must never take serving down); the last 256
    events are always kept in memory."""

    def __init__(self, path=None):
        self._path = path
        self._resolved = path is not None
        self._lock = threading.Lock()
        self.events = collections.deque(maxlen=256)

    def _resolve(self):
        if self._resolved:
            return self._path
        self._resolved = True
        log_dir = (os.environ.get("PT_ANOMALY_DIR")
                   or os.environ.get("PADDLE_LOG_DIR"))
        if log_dir:
            rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
            self._path = os.path.join(log_dir,
                                      f"anomalies.rank{rank}.jsonl")
        return self._path

    @property
    def path(self):
        return self._resolve()

    def write(self, kind, **fields):
        _JOURNAL_EVENTS.labels(kind=kind).inc()
        entry = {"t": time.time(),
                 "rank": int(os.environ.get("PADDLE_TRAINER_ID", "0")),
                 "kind": kind}
        entry.update(fields)
        # one event stream: a post-mortem dump carries the anomalies that
        # preceded the failure
        try:
            from ..observability.flight_recorder import record_event

            record_event("journal", entry=dict(entry))
        except Exception:
            pass
        # append under the lock, file I/O outside it: a slow log
        # directory must not queue every journaling thread behind disk
        with self._lock:
            self.events.append(entry)
            path = self._resolve()
        if path:
            try:
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                with open(path, "a") as f:
                    f.write(json.dumps(entry) + "\n")
            except OSError:
                pass
        return entry


_journal = AnomalyJournal()


def record(kind, **fields):
    """Append one event to the per-rank anomaly journal."""
    return _journal.write(kind, **fields)


def events(kind=None):
    """In-memory view of recent journal entries (newest last)."""
    evs = list(_journal.events)
    return evs if kind is None else [e for e in evs if e["kind"] == kind]


def reset():
    """Test hook: clear the retry window and re-resolve the journal
    path."""
    global _journal
    with _recent_lock:
        _recent.clear()
    _journal = AnomalyJournal()


def _a11(name):
    def unported(*a, **kw):
        raise NotImplementedError(
            f"resilience.{name} hardens the distributed training stack, "
            "which is not ported yet: ROADMAP A11")
    unported.__name__ = name
    return unported


RetryPolicy = _a11("RetryPolicy")
StepGuard = _a11("StepGuard")
DivergenceSentinel = _a11("DivergenceSentinel")
PreemptionHandler = _a11("PreemptionHandler")
install_preemption_handler = _a11("install_preemption_handler")
