"""Overload control plane — shedding, cancellation, brownout, breaker
(counterpart of paddle_tpu/inference/fleet_serving/overload.py, host
logic copied: the same transitions under the same `now=` inputs).

The router's failover survives replica death; this module makes the
fleet survive its own CLIENTS. Without it a
saturated fleet has exactly one behaviour: every request's TTFT slides
together until nothing meets any deadline — the classic congestion-
collapse shape. The control plane here turns overload into a first-
class, *typed* outcome instead:

* **Typed rejections.** :class:`RequestShed` (admission refused — the
  request never consumed fleet work; carries a ``retry_after_s`` hint)
  and :class:`RequestCancelled` (the request was admitted and then
  aborted — client ``cancel()`` or deadline expiry). A client future
  ALWAYS resolves with a result or one of these; never a hang.

* **Deadline admission** (:class:`TTFTEstimator`). Requests may carry
  a hard ``deadline_s``. The estimator tracks the FASTEST fleet token
  rate ever observed (peak of per-monitor-tick deltas of the engines'
  ``tokens_in`` counters) plus an EMA of prompt length, giving an
  optimistic lower bound on TTFT behind the current queue. A deadline
  below that bound is *provably* unmeetable — even a fleet running at
  its best-ever rate could not serve it in time — so the router sheds
  at ingress, the cheapest byte never moved. No observed rate → no
  proof → admit (the estimator never guesses against the client).

* **Brownout ladder** (:class:`BrownoutController`). Under sustained
  pressure (queue depth per alive replica ≥ ``brownout_high`` for
  ``brownout_step_ticks`` monitor ticks) the fleet steps DOWN through
  journaled levels — shrink spec_k → disable speculation and release
  the draft pool → shrink the fused decode window and cap
  max_new_tokens → shed the best-effort class at ingress — and steps
  back UP with hysteresis (pressure ≤ ``brownout_low`` for
  ``brownout_recover_ticks`` ticks). Every cap is a host-side clamp on
  a per-window input (widths / remainders ride the static buffers of
  the captured windows), so the ladder never recaptures a graph. Each transition journals, stamps a flight-recorder
  ``brownout_transition`` event, and moves ``pt_fleet_brownout_level``.

* **Circuit breaker** (:class:`CircuitBreaker`). Failover only
  reacts to a *dead* prefill tier; the breaker reacts to a *sick* one.
  A windowed failure(/latency) rate at/above ``breaker_failure_rate``
  opens the breaker and the router falls back to whole-request serving
  on the decode tier; after ``breaker_reset_s`` one half-open probe
  decides re-close vs re-open. States surface as
  ``pt_prefill_breaker_state`` (0 closed · 0.5 half-open · 1 open).

Defaults are deliberately inert where behaviour would change: brownout
and hedging are opt-in (``brownout_high=None`` / ``hedge_after_s=
None``), the parking bound is generous, and the breaker counts
failures only (``breaker_latency_s=None``) so a slow CI host never
flips it. docs/SERVING.md "Overload and degradation" is the contract.
"""
import collections
import threading
import time

from ...observability import flight_recorder as _flight
from ...observability import metrics as _obs

__all__ = ["RequestShed", "RequestCancelled", "OverloadPolicy",
           "TTFTEstimator", "CircuitBreaker", "BrownoutController",
           "DEFAULT_BROWNOUT_LEVELS", "note_shed", "note_cancelled",
           "note_hedge"]

_SHED_TOTAL = _obs.counter(
    "pt_requests_shed_total",
    "requests refused at admission with a typed RequestShed, by reason "
    "(deadline | deadline_unmeetable | brownout | capacity | "
    "no_capacity) — a shed request consumed no fleet work",
    labelnames=("reason",))
_CANCELLED_TOTAL = _obs.counter(
    "pt_requests_cancelled_total",
    "admitted requests aborted mid-flight, by reason (client | "
    "deadline) — slots, pool pages and trie pins are freed and the "
    "client future resolves with RequestCancelled",
    labelnames=("reason",))
_BROWNOUT_LEVEL = _obs.gauge(
    "pt_fleet_brownout_level",
    "current brownout degradation level (0 = full service; each step "
    "applies the cumulative caps of docs/SERVING.md's ladder)")
_BREAKER_STATE = _obs.gauge(
    "pt_prefill_breaker_state",
    "prefill hand-off circuit breaker state: 0 closed, 0.5 half-open "
    "(single probe outstanding), 1 open (whole-request fallback)")
_BREAKER_OPENS = _obs.counter(
    "pt_prefill_breaker_opens_total",
    "times the prefill circuit breaker opened (windowed failure/"
    "latency rate crossed the threshold, or a half-open probe failed)")
_HEDGES = _obs.counter(
    "pt_router_hedges_total",
    "hedged re-dispatches: an in-flight request re-sent to a healthy "
    "replica because its current one stopped ticking (first completion "
    "wins; the duplicate attempt's outcome is suppressed)")


def note_shed(reason):
    """Count one shed (reason labels: module docstring)."""
    _SHED_TOTAL.labels(reason=reason).inc()


def note_cancelled(reason):
    """Count one mid-flight cancellation."""
    _CANCELLED_TOTAL.labels(reason=reason).inc()


def note_hedge():
    """Count one hedged re-dispatch."""
    _HEDGES.inc()


class RequestShed(RuntimeError):
    """Admission refused — the request consumed no fleet work.

    ``reason``        why (docs/SERVING.md table)
    ``retry_after_s`` optimistic seconds until a retry could be
                      admitted (None: retry timing is not the issue,
                      e.g. the deadline already expired at submit)
    ``trace_id``      the request's trace identity, when it got far
                      enough to have one
    """

    def __init__(self, reason, retry_after_s=None, trace_id=None):
        self.reason = reason
        self.retry_after_s = retry_after_s
        self.trace_id = trace_id
        hint = ("" if retry_after_s is None
                else f" (retry after ~{retry_after_s:.3f}s)")
        super().__init__(f"request shed: {reason}{hint}")


class RequestCancelled(RuntimeError):
    """An ADMITTED request was aborted mid-flight (client cancel or
    deadline expiry); its slots/pages/pins were freed."""

    def __init__(self, reason="client", trace_id=None):
        self.reason = reason
        self.trace_id = trace_id
        super().__init__(f"request cancelled: {reason}")


class OverloadPolicy:
    """Control-plane knobs (docs/SERVING.md has the tuning table).

    max_parked          bound on the all-replicas-dead parking queue;
                        beyond it the worst parked request sheds
    max_inflight        bound on total router-tracked requests (None:
                        unbounded); beyond it the worst parked request
                        — or the newcomer — sheds
    brownout_high       queue-depth-per-alive-replica at/above which a
                        monitor tick counts HOT (None: brownout off)
    brownout_low        pressure at/below which a tick counts COOL
                        (None: half of brownout_high)
    brownout_step_ticks     consecutive hot ticks per step DOWN
    brownout_recover_ticks  consecutive cool ticks per step UP
    brownout_levels     override ladder (tuple of caps dicts; None:
                        DEFAULT_BROWNOUT_LEVELS)
    breaker_window      sliding event window for the prefill breaker
    breaker_failure_rate    bad fraction at/above which it opens
    breaker_latency_s   prefill hand-off latency counted as bad (None:
                        failures only — the CI-safe default)
    breaker_min_events  minimum window occupancy before evaluating
    breaker_reset_s     open -> half-open probe delay
    hedge_after_s       request age before it is hedge-eligible (None:
                        hedging off)
    hedge_stale_s       replica tick staleness that marks it wedged
                        (None: a quarter of the heartbeat timeout — a
                        hedge must fire BEFORE failover would)
    """

    def __init__(self, max_parked=256, max_inflight=None,
                 brownout_high=None, brownout_low=None,
                 brownout_step_ticks=3, brownout_recover_ticks=10,
                 brownout_levels=None,
                 breaker_window=16, breaker_failure_rate=0.5,
                 breaker_latency_s=None, breaker_min_events=4,
                 breaker_reset_s=2.0,
                 hedge_after_s=None, hedge_stale_s=None):
        self.max_parked = int(max_parked)
        self.max_inflight = (None if max_inflight is None
                             else int(max_inflight))
        self.brownout_high = (None if brownout_high is None
                              else float(brownout_high))
        self.brownout_low = (None if brownout_low is None
                             else float(brownout_low))
        self.brownout_step_ticks = int(brownout_step_ticks)
        self.brownout_recover_ticks = int(brownout_recover_ticks)
        self.brownout_levels = brownout_levels
        self.breaker_window = int(breaker_window)
        self.breaker_failure_rate = float(breaker_failure_rate)
        self.breaker_latency_s = (None if breaker_latency_s is None
                                  else float(breaker_latency_s))
        self.breaker_min_events = int(breaker_min_events)
        self.breaker_reset_s = float(breaker_reset_s)
        self.hedge_after_s = (None if hedge_after_s is None
                              else float(hedge_after_s))
        self.hedge_stale_s = (None if hedge_stale_s is None
                              else float(hedge_stale_s))


class TTFTEstimator:
    """Optimistic TTFT lower bound from live fleet telemetry.

    ``note_progress`` feeds cumulative fleet ``tokens_in`` samples from
    the router monitor; the PEAK observed rate between samples is kept
    (negative deltas — a replica died or re-warmed and its counter left
    the sum — are discarded). ``note_prompt`` keeps an EMA of prompt
    length so queue depth converts to queued *tokens*. The bound
    ``lower_bound_ttft = queued_tokens / peak_rate`` is optimistic by
    construction — the real fleet never beats its best-ever rate — so
    shedding on it is provable, and NO observed rate yields bound 0.0
    (admit: the estimator never guesses against the client)."""

    def __init__(self, prompt_ema=0.2):
        self._lock = threading.Lock()
        self._alpha = float(prompt_ema)
        self._avg_prompt = 0.0
        self._peak_rate = 0.0      # tokens/s, best ever observed
        self._last = None          # (cum_tokens, t_monotonic)

    def note_prompt(self, n_tokens):
        with self._lock:
            if self._avg_prompt <= 0.0:
                self._avg_prompt = float(n_tokens)
            else:
                self._avg_prompt += self._alpha * (float(n_tokens)
                                                   - self._avg_prompt)

    def note_progress(self, cum_tokens, t=None):
        t = time.monotonic() if t is None else float(t)
        with self._lock:
            last, self._last = self._last, (float(cum_tokens), t)
            if last is None:
                return
            dtok, dt = cum_tokens - last[0], t - last[1]
            if dtok <= 0.0 or dt <= 0.0:
                return
            self._peak_rate = max(self._peak_rate, dtok / dt)

    def avg_prompt_tokens(self):
        with self._lock:
            return self._avg_prompt

    def peak_rate(self):
        with self._lock:
            return self._peak_rate

    def lower_bound_ttft(self, queued_tokens):
        """Optimistic seconds before a request behind `queued_tokens`
        of work sees its first token; 0.0 while no rate is known."""
        with self._lock:
            if self._peak_rate <= 0.0:
                return 0.0
            return float(queued_tokens) / self._peak_rate

    def snapshot(self):
        with self._lock:
            return {"peak_rate_tok_s": round(self._peak_rate, 3),
                    "avg_prompt_tokens": round(self._avg_prompt, 2)}


class CircuitBreaker:
    """Windowed failure(/latency) breaker for the prefill hand-off.

    closed -> open when the sliding window (>= min_events deep) holds a
    bad fraction >= failure_rate; bad = a failed hand-off, or — with
    latency_s set — one slower than latency_s. open -> half_open after
    reset_s; half_open admits EXACTLY one probe: a clean success closes
    (and forgets the window), anything else re-opens and restarts the
    timer."""

    def __init__(self, window=16, failure_rate=0.5, latency_s=None,
                 min_events=4, reset_s=2.0):
        self._lock = threading.Lock()
        self._events = collections.deque(maxlen=int(window))
        self.failure_rate = float(failure_rate)
        self.latency_s = None if latency_s is None else float(latency_s)
        self.min_events = int(min_events)
        self.reset_s = float(reset_s)
        self.state = "closed"
        self.opens = 0
        self._opened_t = 0.0
        self._probe_out = False
        self._probe_t = 0.0
        _BREAKER_STATE.set(0.0)

    def allow(self, now=None):
        """May a prefill hand-off be attempted right now?"""
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                if now - self._opened_t < self.reset_s:
                    return False
                self.state = "half_open"
                self._probe_out = False
                _BREAKER_STATE.set(0.5)
                _flight.record_event("breaker_half_open")
            if self._probe_out:
                # an abandoned probe (its replica died; the future was
                # superseded and never reports) must not wedge the
                # breaker half-open forever — age it out
                if now - self._probe_t < max(self.reset_s, 1.0):
                    return False
            self._probe_out = True
            self._probe_t = now
            return True

    def record_success(self, latency_s=0.0, now=None):
        with self._lock:
            slow = (self.latency_s is not None
                    and float(latency_s) > self.latency_s)
            self._events.append(not slow)
            if self.state == "half_open":
                if slow:
                    self._open(now)
                    return
                self.state = "closed"
                self._events.clear()
                _BREAKER_STATE.set(0.0)
                _flight.record_event("breaker_closed")
                return
            if self.state == "closed":
                self._evaluate(now)

    def record_failure(self, now=None):
        with self._lock:
            self._events.append(False)
            if self.state == "half_open":
                self._open(now)
            elif self.state == "closed":
                self._evaluate(now)

    # both called with the lock held
    def _evaluate(self, now):
        n = len(self._events)
        if n < self.min_events:
            return
        bad = n - sum(self._events)
        if bad / n >= self.failure_rate:
            self._open(now)

    def _open(self, now):
        self.state = "open"
        self._opened_t = time.monotonic() if now is None else float(now)
        self._probe_out = False
        # _open runs with self._lock held (record_* / _evaluate)
        self.opens += 1
        _BREAKER_OPENS.inc()
        _BREAKER_STATE.set(1.0)
        _flight.record_event("breaker_open", opens=self.opens,
                             window=list(self._events))

    def snapshot(self):
        with self._lock:
            return {"state": self.state, "opens": self.opens,
                    "window": list(self._events)}


# cumulative caps per level; every cap is a host-side clamp on a
# per-window input (widths/remainders/targets) — never a recapture
DEFAULT_BROWNOUT_LEVELS = (
    {},                                           # L0: full service
    {"spec_k_cap": 2},                            # L1: shrink spec_k
    {"spec_enabled": False},                      # L2: spec off, draft
                                                  #     pool released
    {"spec_enabled": False, "decode_k_cap": 2,    # L3: + window/output
     "max_new_cap": 32},                          #     caps
    {"spec_enabled": False, "decode_k_cap": 2,    # L4: + stop pinning
     "max_new_cap": 32, "session_pin": False},    #     session KV: the
                                                  #     engine sheds
                                                  #     convenience
                                                  #     state (multi-
                                                  #     turn frontiers
                                                  #     re-prefill)
                                                  #     BEFORE any
                                                  #     traffic is
                                                  #     refused
    {"spec_enabled": False, "decode_k_cap": 2,    # L5: + shed the
     "max_new_cap": 32, "session_pin": False,     #     best-effort
     "shed_priority": 2},                         #     (BATCH) class
)


class BrownoutController:
    """Journaled, hysteretic degradation ladder (module docstring).

    ``note_pressure`` is called once per router monitor tick with the
    fleet pressure (queue depth per alive replica); a step only fires
    after ``step_ticks``/``recover_ticks`` CONSECUTIVE hot/cool ticks,
    and a mid-band tick resets both streaks — the ladder cannot
    oscillate on a noisy boundary. Inert when ``brownout_high`` is
    None."""

    def __init__(self, policy, apply_fn=None):
        self.policy = policy
        self.apply_fn = apply_fn     # fn(level, caps) on transition
        self.levels = tuple(dict(lv) for lv in
                            (policy.brownout_levels
                             or DEFAULT_BROWNOUT_LEVELS))
        self._lock = threading.Lock()
        self.level = 0
        self._hot = 0
        self._cool = 0
        self._entered_t = None
        self.journal = []            # [{t, from, to, pressure}], bounded
        self.dwell_s = [0.0] * len(self.levels)

    @property
    def enabled(self):
        return self.policy.brownout_high is not None

    def shed_priority(self):
        """Priority value at/above which ingress sheds (None: no class
        is being shed at the current level)."""
        return self.levels[self.level].get("shed_priority")

    def caps(self):
        return dict(self.levels[self.level])

    def note_pressure(self, pressure, now=None):
        pol = self.policy
        if pol.brownout_high is None:
            return self.level
        now = time.monotonic() if now is None else float(now)
        low = (pol.brownout_low if pol.brownout_low is not None
               else 0.5 * pol.brownout_high)
        with self._lock:
            if self._entered_t is None:
                self._entered_t = now
            target = None
            if pressure >= pol.brownout_high:
                self._hot, self._cool = self._hot + 1, 0
                if (self._hot >= pol.brownout_step_ticks
                        and self.level < len(self.levels) - 1):
                    target, self._hot = self.level + 1, 0
            elif pressure <= low:
                self._cool, self._hot = self._cool + 1, 0
                if (self._cool >= pol.brownout_recover_ticks
                        and self.level > 0):
                    target, self._cool = self.level - 1, 0
            else:
                self._hot = self._cool = 0
            if target is None:
                return self.level
            prev, self.level = self.level, target
            self.dwell_s[prev] += now - self._entered_t
            self._entered_t = now
            self.journal.append({"t": now, "from": prev, "to": target,
                                 "pressure": round(float(pressure), 3)})
            del self.journal[:-256]
            caps = dict(self.levels[target])
            fn = self.apply_fn
        _BROWNOUT_LEVEL.set(float(target))
        _flight.record_event("brownout_transition", level_from=prev,
                             level_to=target,
                             pressure=round(float(pressure), 3),
                             caps=caps)
        if fn is not None:
            try:
                fn(target, caps)
            except Exception as e:
                # the ladder still advanced — but a failing apply hook
                # means the fleet did NOT degrade; leave a trace
                _flight.record_event("brownout_apply_failed",
                                     level=target, error=repr(e))
        return target

    def dwell(self, now=None):
        """Seconds spent at each level so far (current level's open
        interval included) — the bench's brownout-dwell stamp."""
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            out = list(self.dwell_s)
            if self._entered_t is not None:
                out[self.level] += now - self._entered_t
            return out

    def snapshot(self):
        with self._lock:
            return {"level": self.level,
                    "enabled": self.enabled,
                    "caps": dict(self.levels[self.level]),
                    "transitions": len(self.journal),
                    "journal_tail": self.journal[-8:]}
