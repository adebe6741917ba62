"""Transient-fault hardening and the anomaly journal (counterpart of
paddle_tpu/distributed/resilience.py; the same names, journal kinds,
metrics and messages).

One :class:`RetryPolicy` (exponential backoff + jitter + deadline) is
applied uniformly to the store gets and sets in ``xproc`` and to the p2p
transport's reconnects and resends, so every transient-fault path shares
one telemetry stream. :class:`StepGuard` detects NaN/Inf losses and
skips-and-journals the step with a bounded consecutive-skip abort;
:class:`DivergenceSentinel` is its escalation for steps whose update is
already applied when the loss reaches the host — NaN/Inf or a loss spike
demands a checkpoint ROLLBACK (:class:`DivergenceRollback`) with a
poisoned-data-window skip set and a bounded rollback budget.
:class:`PreemptionHandler` turns SIGTERM into a drain-to-final-checkpoint
instead of a mid-step kill.

Every event lands in one per-rank JSONL journal
(``$PADDLE_LOG_DIR/anomalies.rank<r>.jsonl``; ``$PT_ANOMALY_DIR``
overrides the directory) and in an in-memory ring of the last 256
events, so tests, post-mortems and the heartbeat thread (degraded-vs-dead
marking, launch/master.py) read the same stream without touching disk.
The file format is the reference's, line for line. Each event is also
mirrored into the flight recorder's ring and counted in
``pt_journal_events_total{kind}`` on the port's registry.

Faults are *provoked* by the sibling ``chaos`` module; this module is
the hardening the injectors exercise.
"""
import collections
import json
import math
import os
import random
import signal
import threading
import time

from ..observability import metrics as _obs

__all__ = ["RetryPolicy", "RetryError", "StepGuard", "StepAbort",
           "DivergenceSentinel", "DivergenceRollback",
           "PreemptionHandler", "install_preemption_handler",
           "AnomalyJournal", "record", "events", "recent_failures",
           "stats", "reset"]


# ------------------------------------------------------------- telemetry

stats = {"retries": collections.Counter(),   # policy name -> retry count
         "giveups": collections.Counter()}   # policy name -> exhausted

# per-call names carry the target ("kv.get:<key>"): label by the op
# prefix only, or every key becomes its own series
_RETRIES_TOTAL = _obs.counter(
    "pt_retries_total", "transient-fault retries, by operation",
    labelnames=("op",))
_GIVEUPS_TOTAL = _obs.counter(
    "pt_retry_giveups_total", "retry budgets exhausted, by operation",
    labelnames=("op",))
_JOURNAL_EVENTS = _obs.counter(
    "pt_journal_events_total", "anomaly-journal events, by kind",
    labelnames=("kind",))
_ROLLBACKS_TOTAL = _obs.counter(
    "pt_rollback_total",
    "DivergenceSentinel-triggered checkpoint rollbacks, by reason "
    "(nan | loss_spike)", labelnames=("reason",))

_recent = collections.deque(maxlen=512)      # (t_monotonic, policy name)
_recent_lock = threading.Lock()


def recent_failures(window_s=30.0):
    """Retry events observed in the last `window_s` seconds — the
    degraded-rank signal the heartbeat thread reports to the membership
    master (a rank that is beating but retry-storming is *degraded*, not
    dead; the launcher logs it instead of failing the pod)."""
    cut = time.monotonic() - window_s
    with _recent_lock:
        return sum(1 for t, _ in _recent if t >= cut)


def _note_retry(name):
    _RETRIES_TOTAL.labels(op=name.split(":", 1)[0]).inc()
    with _recent_lock:
        stats["retries"][name] += 1
        _recent.append((time.monotonic(), name))


# --------------------------------------------------------------- journal

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
    """Test hook: clear telemetry and re-resolve the journal path."""
    global _journal
    stats["retries"].clear()
    stats["giveups"].clear()
    with _recent_lock:
        _recent.clear()
    _journal = AnomalyJournal()


# ----------------------------------------------------------- RetryPolicy

class RetryError(TimeoutError):
    """All attempts exhausted (count or deadline). `.last` holds the
    final underlying exception (also chained as __cause__)."""

    def __init__(self, msg, last=None):
        super().__init__(msg)
        self.last = last


class RetryPolicy:
    """Exponential backoff + jitter + deadline.

    ``run(fn)`` calls `fn` until it returns, retrying exceptions listed
    in `retry_on` while attempts and the deadline budget last. Sleeps
    ``base_s * multiplier**attempt`` (capped at `max_backoff_s`) plus up
    to ``jitter`` fractional randomization, never past the deadline.

    `max_attempts=None` retries until the deadline alone — the right
    shape for "peer is mid-restart" waits where the caller's timeout is
    the real budget.

    `give_up_on` lists exception types (subclasses of `retry_on` shapes)
    that are NEVER transient for this operation — they exhaust
    immediately, raising the same RetryError the caller already handles,
    without burning backoff sleeps (e.g. FileNotFoundError on a
    checkpoint shard: the file will not appear on retry).
    """

    def __init__(self, max_attempts=5, base_s=0.05, multiplier=2.0,
                 max_backoff_s=2.0, deadline_s=None, jitter=0.25,
                 retry_on=(OSError,), give_up_on=(), name="op", rng=None):
        self.max_attempts = max_attempts
        self.base_s = base_s
        self.multiplier = multiplier
        self.max_backoff_s = max_backoff_s
        self.deadline_s = deadline_s
        self.jitter = jitter
        self.retry_on = tuple(retry_on)
        self.give_up_on = tuple(give_up_on)
        self.name = name
        self._rng = rng or random

    def backoff(self, attempt):
        """Sleep length after failed attempt `attempt` (0-based)."""
        raw = min(self.base_s * self.multiplier ** attempt,
                  self.max_backoff_s)
        return raw * (1.0 + self.jitter * self._rng.random())

    def run(self, fn, *args, deadline_s=None, name=None, on_retry=None,
            **kwargs):
        name = name or self.name
        budget = self.deadline_s if deadline_s is None else deadline_s
        deadline = None if budget is None else time.monotonic() + budget
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except self.retry_on as e:
                attempt += 1
                if isinstance(e, self.give_up_on):
                    stats["giveups"][name] += 1
                    _GIVEUPS_TOTAL.labels(op=name.split(":", 1)[0]).inc()
                    record("retry_exhausted", op=name, attempts=attempt,
                           error=repr(e))
                    raise RetryError(
                        f"{name}: non-transient failure: {e!r}",
                        last=e) from e
                _note_retry(name)
                record("retry", op=name, attempt=attempt, error=repr(e))
                if on_retry is not None:
                    on_retry(attempt, e)
                out_of_attempts = (self.max_attempts is not None
                                   and attempt >= self.max_attempts)
                delay = self.backoff(attempt - 1)
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        out_of_attempts = True
                    else:
                        delay = min(delay, remaining)
                if out_of_attempts:
                    stats["giveups"][name] += 1
                    _GIVEUPS_TOTAL.labels(op=name.split(":", 1)[0]).inc()
                    record("retry_exhausted", op=name, attempts=attempt,
                           error=repr(e))
                    raise RetryError(
                        f"{name}: gave up after {attempt} attempt(s): "
                        f"{e!r}", last=e) from e
                time.sleep(delay)


# ------------------------------------------------------------- StepGuard

class StepAbort(RuntimeError):
    """Too many consecutive skipped steps — the anomaly is systemic
    (diverged optimizer, corrupted params), not transient; let the
    elastic layer restore a checkpoint instead of burning data."""


def _scalar(value):
    """float() of a loss however it arrives: a torch tensor on either
    device, numpy, or a python scalar. (Forces a device sync — NaN
    detection is inherently a sync point; call once per step.)"""
    import torch

    if isinstance(value, torch.Tensor):
        return float(value.detach().reshape(-1)[0].float().cpu())
    try:
        return float(value)
    except (TypeError, ValueError):
        import numpy as np

        return float(np.asarray(value).reshape(-1)[0])


class StepGuard:
    """Step-level failure guard: NaN/Inf losses are skipped-and-journaled
    with a bounded consecutive-skip abort. `max_consecutive_skips` is the
    ALLOWANCE: that many consecutive skips are tolerated, and the skip
    that exceeds it raises StepAbort.

    Usage (eager loop — check BEFORE applying the update)::

        guard = StepGuard(max_consecutive_skips=3)
        while step < STEPS:
            loss = loss_fn(...)
            if not guard.check(loss, step=step):
                continue            # retry (transient) or advance (skip)
            loss.backward(); opt.step(); opt.clear_grad()
            step += 1

    Where the update is fused into the step, `check` gates *persisting*
    the step (checkpoint / step advance), and recovery from a poisoned
    update is a checkpoint restore (DivergenceSentinel).

    Chaos integration: each check fires scope ``step`` (crash/hang-at-
    step-N injectors) and routes the loss value through the
    ``step.nan`` poisoner, so the detection path itself is exercised.
    """

    def __init__(self, max_consecutive_skips=5, name="train"):
        self.max_consecutive_skips = max_consecutive_skips
        self.name = name
        self.skipped = 0            # total skipped steps
        self.ok = 0                 # total accepted steps
        self._consecutive = 0

    def check(self, loss, step=None):
        """True → proceed with the update; False → skip this step
        (already journaled). Raises StepAbort on the skip that exceeds
        the `max_consecutive_skips` allowance."""
        from . import chaos

        chaos.fire("step")          # crash/hang-at-step-N injectors
        value = chaos.poison(_scalar(loss))
        if math.isfinite(value):
            self._consecutive = 0
            self.ok += 1
            return True
        self.skipped += 1
        self._consecutive += 1
        record("nan_step", guard=self.name, step=step, value=str(value),
               consecutive=self._consecutive)
        if self._consecutive > self.max_consecutive_skips:
            record("step_abort", guard=self.name, step=step,
                   consecutive=self._consecutive)
            raise StepAbort(
                f"{self.name}: {self._consecutive} consecutive non-finite "
                f"losses (> {self.max_consecutive_skips}) at step {step}")
        return False


# ---------------------------------------------- DivergenceSentinel

class DivergenceRollback(RuntimeError):
    """The sentinel demands a checkpoint rollback: the live parameters
    are presumed poisoned (a fused-update compiled step applies the
    update BEFORE the loss is observable on the host), so skipping
    forward is not enough — restore the last COMPLETE checkpoint and
    advance past the poisoned data window.
    `fleet.elastic.run_with_fault_tolerance` catches this and restores
    WITHOUT consuming a restart (the sentinel bounds its own budget)."""

    def __init__(self, msg, step=None, reason="nan", value=None):
        super().__init__(msg)
        self.step = step
        self.reason = reason
        self.value = value


class DivergenceSentinel:
    """Divergence monitor + rollback trigger over the per-step loss
    telemetry — StepGuard's escalation path for train steps that apply the update before the loss is read.

    StepGuard's skip-and-retry is the right call for an EAGER loop,
    where a NaN loss can gate the update. Where the optimizer update
    runs inside the step (`jit.TrainStep`), by the time the host sees the loss,
    the parameters are already updated — a NaN or a spiking loss means
    the live state may be poisoned. The sentinel therefore journals the
    anomaly, marks the poisoned data window (``should_skip``), and
    raises :class:`DivergenceRollback` so the supervision loop
    (`run_with_fault_tolerance`) restores the last COMPLETE checkpoint
    and resumes in-process through `Checkpointer.load` — no pod
    restart.

    Detection: non-finite loss (reason ``nan``), or — once
    ``min_history`` finite losses are in the rolling window — a loss
    above ``spike_factor`` × the window median (reason ``loss_spike``;
    assumes the positive-loss shape of CE/MSE objectives).
    ``max_rollbacks`` bounds the budget: the rollback that exceeds it
    raises StepAbort instead (systemic divergence — hand the job to the
    elastic restart layer rather than thrash restore/replay forever).

    Usage inside a run_with_fault_tolerance train_fn::

        sentinel = DivergenceSentinel()
        def train_fn(start):
            step = start
            while step < STEPS:
                if sentinel.should_skip(step):   # poisoned data window
                    advance_data(); step += 1; continue
                loss = train_step(*batch(step))
                sentinel.check(loss, step=step)  # raises on divergence
                ckpt.save(step + 1); step += 1

    Chaos integration mirrors StepGuard: every check fires scope
    ``step`` and routes the observed loss through the ``step.nan``
    poisoner. Thread-shared: the heartbeat/telemetry threads read
    counters while the train loop writes them — all mutation is under
    one lock."""

    def __init__(self, window=16, spike_factor=4.0, min_history=4,
                 max_rollbacks=3, skip_window=1, name="train"):
        self.window = int(window)
        self.spike_factor = float(spike_factor)
        self.min_history = max(1, int(min_history))
        self.max_rollbacks = int(max_rollbacks)
        self.skip_window = max(1, int(skip_window))
        self.name = name
        self.rollbacks = 0          # rollbacks demanded so far
        self.ok = 0                 # accepted steps
        self._lock = threading.Lock()
        self._history = collections.deque(maxlen=self.window)
        self._poisoned = set()      # step indices to skip after restore

    def should_skip(self, step):
        """True when `step` sits in a poisoned data window — the loop
        must advance its data pipeline past it WITHOUT dispatching the
        update (replaying the batch that diverged once diverges
        again)."""
        with self._lock:
            return step in self._poisoned

    def poisoned_steps(self):
        with self._lock:
            return sorted(self._poisoned)

    def check(self, loss, step=None):
        """Accept one observed loss. Returns True when training may
        proceed; raises DivergenceRollback (restore + skip window) on
        NaN/Inf or a loss spike, StepAbort past the rollback budget."""
        from . import chaos

        chaos.fire("step")          # crash/hang-at-step-N injectors
        value = chaos.poison(_scalar(loss))
        with self._lock:
            reason = None
            if not math.isfinite(value):
                reason = "nan"
            elif len(self._history) >= self.min_history:
                med = sorted(self._history)[len(self._history) // 2]
                if med > 0 and value > self.spike_factor * med:
                    reason = "loss_spike"
            if reason is None:
                self.ok += 1
                self._history.append(value)
                return True
            # poison the data window ending at `step`, so the resumed
            # run advances past the batches that fed the divergence
            if step is not None:
                for s in range(step - self.skip_window + 1, step + 1):
                    self._poisoned.add(s)
            self.rollbacks += 1
            n = self.rollbacks
        record("rollback", guard=self.name, step=step, reason=reason,
               value=str(value), rollbacks=n)
        if n > self.max_rollbacks:
            record("step_abort", guard=self.name, step=step,
                   rollbacks=n)
            raise StepAbort(
                f"{self.name}: rollback budget exhausted ({n} > "
                f"{self.max_rollbacks}) at step {step} — divergence is "
                "systemic, not transient")
        _ROLLBACKS_TOTAL.labels(reason=reason).inc()
        raise DivergenceRollback(
            f"{self.name}: {reason} at step {step} (loss={value!r}) — "
            "restoring last complete checkpoint",
            step=step, reason=reason, value=value)


# ---------------------------------------------------- PreemptionHandler

class PreemptionHandler:
    """SIGTERM → drain to a final checkpoint and exit cleanly (the
    maintenance-event shape: the scheduler sends SIGTERM, then SIGKILL
    after a grace window). `drain` takes any object with `wait()` and
    `save(step)`.

    The signal handler only sets a flag — the train loop polls
    ``triggered()`` at step boundaries and calls ``drain(checkpointer,
    step)``, so the checkpoint is taken at a consistent point instead of
    mid-step. Must be installed from the main thread."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._flag = threading.Event()
        self._signum = None
        self._signal_logged = False
        self._old = {}
        for sig in signals:
            self._old[sig] = signal.signal(sig, self._on_signal)

    def _on_signal(self, signum, frame):
        # flag-set ONLY: record() takes the (non-reentrant) journal lock
        # and does file I/O — from a signal handler that interrupts a
        # journal write it would self-deadlock the main thread
        self._signum = signum
        self._flag.set()

    def _log_signal(self):
        if self._flag.is_set() and not self._signal_logged:
            self._signal_logged = True
            record("preempt_signal", signum=self._signum)

    def triggered(self):
        self._log_signal()          # journal from the poll site, not
        return self._flag.is_set()  # the signal handler

    def drain(self, checkpointer=None, step=None):
        """Flush pending async saves and take a final checkpoint.
        Returns True once drained (idempotent; safe with no
        checkpointer — then it only journals)."""
        self._log_signal()
        if checkpointer is not None:
            checkpointer.wait()
            if step is not None:
                checkpointer.save(step)
                checkpointer.wait()
        record("preempt_drain", step=step)
        return True

    def restore(self):
        """Reinstate the signal handlers that were active before."""
        for sig, old in self._old.items():
            signal.signal(sig, old)
        self._old.clear()


def install_preemption_handler(signals=(signal.SIGTERM,)):
    """Install and return a PreemptionHandler (main thread only)."""
    return PreemptionHandler(signals=signals)
