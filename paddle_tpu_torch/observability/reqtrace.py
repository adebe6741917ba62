"""Request-scoped distributed tracing — trace contexts + TTFT phases
(counterpart of paddle_tpu/observability/reqtrace.py; the wire dict of
`TraceContext.to_dict` is the reference's, key for key, so a payload's
trace restores in either package).

A serving request in the disaggregated fleet crosses four actors
(router → prefill replica → KV wire → decode replica), and a slow TTFT
or a failover can only be debugged if every span and timestamp the
request touches carries ONE identity. This module is that identity:

* :class:`TraceContext` — a ``trace_id`` (+ optional parent span id)
  generated at the ingress (`FleetRouter.submit` / `LLMServer.submit`)
  that rides the engine `_Request`, the `KVPagePayload` header, and —
  via `tracing.ambient_trace` — the spans of any transport call made on
  the request's behalf (the `xproc.send` frame that ships its KV pages
  carries the trace_id in its span args AND in the payload header).
  ``to_dict``/``from_dict`` are the wire form: a payload imported on
  another replica/process reconstructs the SAME trace, phase stamps
  included, so the timeline keeps accumulating across hand-offs.

* **Phase stamps** — ``ctx.stamp(phase)`` records a wall-clock,
  first-wins timestamp (``queued``, ``routed``, ``prefill_start``,
  ``prefill_end``, ``kv_export``, ``kv_transfer``, ``kv_import``,
  ``first_decode_dispatch``, ``first_token``; docs/OBSERVABILITY.md
  "TTFT decomposition" defines each). First-wins makes preemption
  replay and failover re-dispatch no-ops: the timeline stays the FIRST
  attempt's truth. Each new stamp emits the segment since the previous
  stamp three ways: a ``pt_request_phase_seconds{phase}`` histogram
  sample (phase = the segment's END stamp), a flight-recorder
  ``request_phase`` event (metrics mode and up — so a postmortem ring
  holds the killed request's recent segments), and in full mode a
  ``phase.<name>`` chrome event, which is what makes a disaggregated
  request read as one causal chain in the merged timeline.

Because the stamps form one monotone wall-clock chain from ``queued``
to ``first_token``, the per-phase durations sum EXACTLY to the
wall-clock TTFT — the decomposition accounts for the whole latency,
never a subset (pinned by tests/test_request_tracing.py; the bench's
``ttft_phase_breakdown`` stamp is built from these timelines).
"""
import os
import time

from . import tracing
from .metrics import _STATE, histogram, summarize_histogram_cell

__all__ = ["TraceContext", "new_trace", "quiet_trace", "PHASES",
           "phase_summary"]

# canonical stamp names (docs/OBSERVABILITY.md has the glossary); the
# chain is temporal, not positional — a request only ever takes the
# stamps its path crosses (no router -> no `routed`; no disaggregation
# -> no kv_* stamps) and segments pair consecutive PRESENT stamps
PHASES = ("queued", "routed", "kv_spill", "kv_prefetch",
          "prefill_start", "prefill_end",
          "kv_export", "kv_transfer", "kv_import",
          "first_decode_dispatch", "first_token")

_PHASE_SECONDS = histogram(
    "pt_request_phase_seconds",
    "per-request TTFT decomposition: seconds from the previous phase "
    "stamp to this one (phase = the segment's END stamp; the segments "
    "of one request sum to its wall-clock TTFT)",
    labelnames=("phase",))


def _new_id(nbytes=8):
    return os.urandom(nbytes).hex()


class TraceContext:
    """One request's identity + phase timeline (module docstring).
    Stamps are first-wins and idempotent, so the object is safe to
    share across a stale and a live failover attempt (both run the
    same request; the first attempt's stamps are the timeline)."""

    __slots__ = ("trace_id", "parent_id", "phases", "quiet", "_last")

    def __init__(self, trace_id=None, parent_id=None, phases=None,
                 quiet=False):
        self.trace_id = trace_id or _new_id()
        self.parent_id = parent_id
        # quiet traces stamp (ordering invariants hold) but emit
        # NOTHING — engine warm-up requests use this so the compile
        # stall inside their prefill segment never pollutes the
        # pt_request_phase_seconds distribution or recent_requests
        self.quiet = bool(quiet)
        self.phases = dict(phases or {})
        # resume from the LATEST pre-existing stamp (the wire form: an
        # imported payload's next stamp measures from the exporter's
        # last one — wall clocks, so cross-process segments align like
        # the chrome `ts` fields do)
        self._last = (max(self.phases.items(), key=lambda kv: kv[1])
                      if self.phases else None)

    def stamp(self, phase, t=None):
        """Record `phase` at wall-clock `t` (now). Returns False when
        the phase was already stamped (replay/requeue: no-op)."""
        if phase in self.phases:
            return False
        t = time.time() if t is None else float(t)
        prev = self._last
        self.phases[phase] = t
        self._last = (phase, t)
        if _STATE.mode and prev is not None and not self.quiet:
            dt = max(0.0, t - prev[1])
            _PHASE_SECONDS.labels(phase=phase).observe(dt)
            self._emit(phase, prev, dt)
        return True

    def _emit(self, phase, prev, dt):
        # ring first (metrics mode and up): the flight recorder must
        # hold a killed request's recent segments even when the span
        # buffer is off
        try:
            from .flight_recorder import record_event

            record_event("request_phase", trace_id=self.trace_id,
                         phase=phase, prev=prev[0], t=self.phases[phase],
                         dur_s=round(dt, 6),
                         replica=tracing.current_replica())
        except Exception:
            pass
        # chrome event (full mode): ts = the segment's START stamp
        tracing.add_event(f"phase.{phase}", int(prev[1] * 1e6),
                          int(dt * 1e6),
                          args={"trace_id": self.trace_id,
                                "from": prev[0]})

    # ---- views ----

    def timeline(self):
        """Stamps in temporal order: [{"phase", "t", "dt_s"}] — dt_s
        measured from the previous stamp (0.0 for the first)."""
        items = sorted(self.phases.items(), key=lambda kv: kv[1])
        out, prev_t = [], None
        for name, t in items:
            # dt_s deliberately UNROUNDED: the exported invariant is
            # that segments sum EXACTLY to total_s — rounding each
            # segment would break the identity by up to n·5e-7
            out.append({"phase": name, "t": t,
                        "dt_s": 0.0 if prev_t is None else t - prev_t})
            prev_t = t
        return out

    def total_s(self):
        """Wall seconds first stamp -> last stamp (== the sum of the
        timeline's dt_s, by construction)."""
        if not self.phases:
            return 0.0
        ts = self.phases.values()
        return max(ts) - min(ts)

    # ---- wire form ----

    def to_dict(self):
        return {"trace_id": self.trace_id, "parent_id": self.parent_id,
                "quiet": self.quiet, "phases": dict(self.phases)}

    @classmethod
    def from_dict(cls, d):
        # `quiet` rides the wire: a warm-up payload restored on the
        # importing side must stay quiet, or its compile-stall
        # segments enter the phase telemetry over there
        return cls(trace_id=d.get("trace_id"),
                   parent_id=d.get("parent_id"),
                   phases=d.get("phases"),
                   quiet=bool(d.get("quiet", False)))


def new_trace(parent_id=None):
    return TraceContext(parent_id=parent_id)


def quiet_trace():
    """A stamp-but-emit-nothing context for WARM-UP requests: their
    prefill segment is the executable compile, and letting it into
    `pt_request_phase_seconds` / recent_requests would report the
    compile stall as serving latency."""
    return TraceContext(quiet=True)


def phase_summary():
    """{phase: {count, sum, p50, p95, p99}} over the process-global
    `pt_request_phase_seconds` histogram — the block
    `LLMServer.metrics()` / `FleetRouter.metrics()` surface."""
    out = {}
    for values, cell in _PHASE_SECONDS._series():
        s = summarize_histogram_cell(cell)
        if not s["count"]:
            continue
        out[values[0]] = {k: (round(v, 6) if isinstance(v, float)
                              else v) for k, v in s.items()}
    return out
