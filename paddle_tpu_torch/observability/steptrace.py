"""Training step tracing — the training twin of reqtrace
(counterpart of paddle_tpu/observability/steptrace.py, over the port's
own registry, flight recorder and tracing).

A train step (jit.TrainStep) spends its wall-clock in phases that only the
framework can tell apart: waiting for the input pipeline, host→device
batch conversion, python dispatch, the device step itself, publishing
updated params back to the live objects — and, between steps, the
synchronous slice of a checkpoint snapshot. This module is the one
identity those phases share, mirroring the reqtrace/TTFT contract:

* :class:`StepTrace` — one step's first-wins phase timeline. The
  instrumented steps stamp ``data_wait`` / ``ckpt_snapshot`` / ``h2d``
  / ``dispatch`` / ``device_step`` (the ``torch.cuda.synchronize`` delta) /
  ``opt_publish``; each new stamp emits the segment since the previous
  stamp three ways: a ``pt_train_phase_seconds{phase}`` histogram
  sample, a flight-recorder ``train_phase`` event, and in full mode a
  ``step.<phase>`` chrome event (per-rank train lanes).
  Stamps form one monotone wall-clock chain, so the per-phase
  durations sum EXACTLY to the step's wall time — unrounded, the same
  identity the TTFT decomposition pins.

* **Quiet warm-up** — a step whose batch signature is NEW pays its
  first-call costs (the reference compiles; the port allocates and
  builds kernels), and that stall must never enter the phase
  histograms. The step classes pass ``quiet=True`` for such steps: the
  trace still stamps (ordering invariants hold, tests use it) but
  emits nothing.

* **Goodput gauges** — :func:`arm_goodput` with the analytic
  :func:`model_flops` turns every completed non-quiet step into
  ``pt_train_mfu`` / ``pt_train_tokens_per_second`` samples, making
  MFU a continuous first-class gauge instead of bench-only hand math.

* **Recompile sentinel** — :func:`note_recompile` counts post-warm-up
  batch-signature growth (``pt_step_recompiles_total{step}``) and
  dumps a flight-recorder postmortem.

* **Straggler attribution** — per-rank step views
  (``StepTrace.to_dict()``) feed :func:`straggler_of`, which
  names the slowest rank of a step and its slow phase.

A bounded ring of recent non-quiet step timelines backs
``recent_steps()`` (the flight-recorder state provider registered at
import), sized by ``PT_STEPTRACE_RING`` (default 256).
"""
import os
import sys
import time

from . import tracing
from .metrics import _STATE, counter, gauge, histogram, \
    summarize_histogram_cell

__all__ = ["StepTrace", "PHASES", "begin_step", "end_step", "active",
           "now", "note_ckpt_snapshot", "note_recompile", "model_flops",
           "arm_goodput", "goodput_armed", "recent_steps", "reset",
           "phase_summary", "straggler_of", "collective_bytes_per_second",
           "DEFAULT_PEAK_FLOPS"]

# segment END-stamp names in temporal order (the internal "start"
# anchor stamp opens the chain and is never a histogram label). A step
# only takes the stamps its path crosses: the first step of a process
# has no previous step to wait on (no data_wait), a run without
# checkpointing never stamps ckpt_snapshot, and device_step needs
# telemetry on (the sync is skipped when nothing would record it).
PHASES = ("ckpt_snapshot", "data_wait", "h2d", "dispatch",
          "device_step", "opt_publish")

# nominal peak used for MFU when the caller doesn't pass one:
# PT_PEAK_FLOPS env override, else the H100's bf16 dense peak (NVIDIA
# data sheet, SXM), the denominator profile_train and chip_smoke divide
# by (the live gauge and the scripts must agree on it)
DEFAULT_PEAK_FLOPS = 989e12

_PHASE_SECONDS = histogram(
    "pt_train_phase_seconds",
    "per-step phase decomposition: seconds from the previous phase "
    "stamp to this one (phase = the segment's END stamp; one step's "
    "segments sum to its wall-clock step time; quiet warm-up/compile "
    "steps excluded)",
    labelnames=("phase",))
_RECOMPILES = counter(
    "pt_step_recompiles_total",
    "post-warm-up batch-signature growth per step family — every "
    "increment is a fresh XLA compile on the training hot path and "
    "dumps a flight-recorder postmortem (reason=step_recompile)",
    labelnames=("step",))
_MFU_GAUGE = gauge(
    "pt_train_mfu",
    "model FLOPs utilization of the last completed non-quiet step: "
    "arm_goodput()'s analytic FLOPs / step wall time / peak FLOPs")
_TOKENS_PER_S = gauge(
    "pt_train_tokens_per_second",
    "training goodput of the last completed non-quiet step: "
    "arm_goodput()'s tokens per step / step wall time")


def now():
    """Wall-clock stamp source. time.time(), not perf_counter: stamps
    from different ranks must align on one timeline, like the chrome
    `ts` fields they become."""
    return time.time()


def active():
    """True when steptrace should measure (telemetry metrics mode or
    up). The instrumented steps skip the device_step sync when nothing
    would record it — tracing must not change OFF-mode queueing."""
    return bool(_STATE.mode)


class StepTrace:
    """One train step's phase timeline (module docstring). Stamps are
    first-wins and idempotent — a preempted/replayed step keeps the
    first attempt's truth, same discipline as reqtrace."""

    __slots__ = ("family", "step", "phases", "quiet", "_last")

    def __init__(self, family, step, phases=None, quiet=False):
        self.family = family
        self.step = int(step)
        self.quiet = bool(quiet)
        self.phases = dict(phases or {})
        self._last = (max(self.phases.items(), key=lambda kv: kv[1])
                      if self.phases else None)

    def stamp(self, phase, t=None):
        """Record `phase` at wall-clock `t` (now). Returns False when
        the phase was already stamped (replay: no-op)."""
        if phase in self.phases:
            return False
        t = now() if t is None else float(t)
        prev = self._last
        self.phases[phase] = t
        self._last = (phase, t)
        if _STATE.mode and prev is not None and not self.quiet:
            dt = max(0.0, t - prev[1])
            _PHASE_SECONDS.labels(phase=phase).observe(dt)
            self._emit(phase, prev, dt)
        return True

    def _emit(self, phase, prev, dt):
        # flight ring first (metrics mode and up): a postmortem must
        # hold the dying step's recent segments even with spans off
        try:
            from .flight_recorder import record_event

            record_event("train_phase", family=self.family,
                         step=self.step, phase=phase, prev=prev[0],
                         t=self.phases[phase], dur_s=round(dt, 6))
        except Exception:  # the guard wraps the trace event itself
            pass
        # chrome event (full mode): ts = the segment's START stamp;
        # args.step is the join key trace_merge.train_report groups on
        tracing.add_event(f"step.{phase}", int(prev[1] * 1e6),
                          int(dt * 1e6),
                          args={"step": self.step, "family": self.family,
                                "from": prev[0]})

    # ---- views ----

    def timeline(self):
        """Stamps in temporal order: [{"phase", "t", "dt_s"}] — dt_s
        deliberately UNROUNDED so the segments sum EXACTLY to
        total_s() (the exported invariant; rounding would break the
        identity by up to n·5e-7)."""
        items = sorted(self.phases.items(), key=lambda kv: kv[1])
        out, prev_t = [], None
        for name, t in items:
            out.append({"phase": name, "t": t,
                        "dt_s": 0.0 if prev_t is None else t - prev_t})
            prev_t = t
        return out

    def total_s(self):
        """Wall seconds first stamp -> last stamp (== sum of the
        timeline's dt_s, by construction)."""
        if not self.phases:
            return 0.0
        ts = self.phases.values()
        return max(ts) - min(ts)

    def end_t(self):
        """Wall time of the latest stamp (the next step's data_wait
        anchor), or None before any stamp."""
        return self._last[1] if self._last else None

    def to_dict(self):
        """Wire form for the cross-rank straggler exchange."""
        return {"family": self.family, "step": self.step,
                "quiet": self.quiet, "phases": dict(self.phases)}


# ------------------------------------------------------------ step flow

# pending synchronous-snapshot interval (t0, t1): Checkpointer.save
# notes it, the NEXT step's trace consumes it as a ckpt_snapshot
# segment — the save runs between steps, so attributing it to the
# following step's pre-data_wait gap keeps the sum identity intact
_PENDING_CKPT = None


def note_ckpt_snapshot(t0, t1):
    """Record a synchronous checkpoint-snapshot interval (wall clock).
    Called by Checkpointer.save; consumed by the next begin_step."""
    global _PENDING_CKPT
    _PENDING_CKPT = (float(t0), float(t1))


def begin_step(family, step, prev_end=None, quiet=False, t_entry=None):
    """Open a step's trace. `prev_end` (the previous step's end_t())
    anchors the chain so the prev-step→this-call gap becomes the
    data_wait segment — input-pipeline stall time the step itself
    never sees. A pending checkpoint-snapshot interval inside that gap
    is carved out as ckpt_snapshot (the anchor→snapshot-start sliver
    rides with it; saves directly follow steps, so it is ≈0)."""
    global _PENDING_CKPT
    t_entry = now() if t_entry is None else float(t_entry)
    tr = StepTrace(family, step, quiet=quiet)
    ckpt, _PENDING_CKPT = _PENDING_CKPT, None
    if prev_end is not None and prev_end <= t_entry:
        tr.stamp("start", prev_end)
        if ckpt is not None and prev_end <= ckpt[1] <= t_entry:
            tr.stamp("ckpt_snapshot", ckpt[1])
        tr.stamp("data_wait", t_entry)
    else:
        # first step of the process (or a clock jump): no anchor, the
        # chain opens at entry and there is no data_wait segment
        tr.stamp("start", t_entry)
    return tr


# bounded ring of recent non-quiet step timelines (flight-recorder
# state provider + tests); PT_STEPTRACE_RING sizes it
try:
    _RING_MAX = max(1, int(os.environ.get("PT_STEPTRACE_RING", "256")))
except ValueError:
    _RING_MAX = 256
_RING = []

# goodput accounting, armed process-wide (one training job per
# process; bench arms/disarms around each arm's run)
_GOODPUT = {"flops": None, "tokens": None, "peak": None}


def arm_goodput(flops_per_step=None, tokens_per_step=None,
                peak_flops=None):
    """Arm the continuous MFU/goodput gauges: every completed
    non-quiet step sets pt_train_mfu = flops_per_step / wall /
    peak_flops and pt_train_tokens_per_second = tokens_per_step /
    wall. Call with no args to disarm. Returns the previous arming."""
    prev = dict(_GOODPUT)
    _GOODPUT["flops"] = None if flops_per_step is None \
        else float(flops_per_step)
    _GOODPUT["tokens"] = None if tokens_per_step is None \
        else float(tokens_per_step)
    if peak_flops is None:
        peak_flops = float(os.environ.get("PT_PEAK_FLOPS",
                                          DEFAULT_PEAK_FLOPS))
    _GOODPUT["peak"] = float(peak_flops)
    return prev


def goodput_armed():
    return _GOODPUT["flops"] is not None or \
        _GOODPUT["tokens"] is not None


def end_step(tr):
    """Close a step's trace: feed the timeline ring and the goodput
    gauges (non-quiet, telemetry on). Returns (total_s, end_t) — the
    step's wall time and the next step's data_wait anchor."""
    total = tr.total_s()
    if _STATE.mode and not tr.quiet and tr._last is not None:
        _RING.append({"family": tr.family, "step": tr.step,
                      "rank": tracing._rank(), "total_s": total,
                      "timeline": tr.timeline()})
        if len(_RING) > _RING_MAX:
            del _RING[:len(_RING) - _RING_MAX]
        if total > 0.0:
            if _GOODPUT["flops"] is not None:
                _MFU_GAUGE.set(
                    _GOODPUT["flops"] / total / _GOODPUT["peak"])
            if _GOODPUT["tokens"] is not None:
                _TOKENS_PER_S.set(_GOODPUT["tokens"] / total)
    return total, tr.end_t()


def recent_steps():
    """Recent non-quiet step timelines, oldest first (bounded ring)."""
    return list(_RING)


def reset():
    """Drop the ring, any pending ckpt interval, and the goodput
    arming (tests)."""
    global _PENDING_CKPT
    del _RING[:]
    _PENDING_CKPT = None
    _GOODPUT["flops"] = _GOODPUT["tokens"] = _GOODPUT["peak"] = None


# ------------------------------------------------------- recompile watch

def note_recompile(family, **context):
    """Count a post-warm-up batch signature and dump a flight-recorder
    postmortem. The step classes call this only for signatures beyond
    their first — the first is expected; growth after it is shape churn
    on the training hot path."""
    _RECOMPILES.labels(step=family).inc()
    if not _STATE.mode:
        return
    try:
        from . import flight_recorder as _fr

        _fr.record_event("step_recompile", family=family, **context)
        _fr.dump("step_recompile", family=family, **context)
    except Exception:  # the guard wraps the trace event itself
        pass


# --------------------------------------------------------- chaos bridge

def chaos_fire(scope):
    """Fire a chaos scope from the step hot path WITHOUT importing the
    distributed package when no plan can be active (the import is paid
    once, and only when PT_CHAOS_PLAN is set or chaos is already
    loaded). An injected delay here lands in the NEXT stamp's segment
    — the straggler chaos test keys on that."""
    if "paddle_tpu_torch.distributed.chaos" not in sys.modules and \
            not os.environ.get("PT_CHAOS_PLAN"):
        return None
    from ..distributed import chaos

    return chaos.fire(scope)


# ------------------------------------------------------ FLOPs accountant

def _cfg_get(config, name, default=None):
    if isinstance(config, dict):
        return config.get(name, default)
    return getattr(config, name, default)


def model_flops(config, batch, seq):
    """Analytic fwd+bwd FLOPs of one decoder-transformer train step:
    6·P per token for the matmuls (fwd 2P + bwd 4P) plus the causal
    attention scores/context terms — the accountant profile_train's MFU
    and the live pt_train_mfu gauge share. `config` is any object/dict
    with hidden_size, num_layers, vocab_size and (optionally) ffn_size."""
    d = int(_cfg_get(config, "hidden_size"))
    L = int(_cfg_get(config, "num_layers"))
    v = int(_cfg_get(config, "vocab_size"))
    ffn = int(_cfg_get(config, "ffn_size", 4 * d) or 4 * d)
    per_layer = 4 * d * d + 2 * d * ffn   # qkv+proj, fc1+fc2 weights
    p_matmul = L * per_layer + v * d      # + tied lm head
    tokens = int(batch) * int(seq)
    matmul = 6 * p_matmul * tokens
    attn = L * batch * (4 * seq * seq * d) * 3 * 0.5  # fwd+2×bwd, causal
    return matmul + attn


# ------------------------------------------------- straggler attribution

def straggler_of(views):
    """Name the slowest rank of one step and its slow phase from
    per-rank step views (`StepTrace.to_dict()` / ring records — any
    dict with "rank"/"phases" or "rank"/"timeline"). The slow phase is
    the segment where the slowest rank's duration exceeds the fastest
    other rank's by the most — a uniform slowdown names the longest
    phase. Returns {"rank", "total_s", "phase", "lag_s", "per_rank"}
    or None for empty input."""
    per_rank = {}
    for i, view in enumerate(views):
        if view is None:
            continue
        rank = int(view.get("rank", i))
        phases = view.get("phases")
        if phases:
            items = sorted(phases.items(), key=lambda kv: kv[1])
            segs, prev_t = {}, None
            for name, t in items:
                if prev_t is not None:
                    segs[name] = t - prev_t
                prev_t = t
            total = items[-1][1] - items[0][1] if len(items) > 1 else 0.0
        else:
            segs = {e["phase"]: e["dt_s"]
                    for e in view.get("timeline", ()) if e["dt_s"]}
            total = view.get("total_s", sum(segs.values()))
        per_rank[rank] = {"total_s": total, "phases_s": segs}
    if not per_rank:
        return None
    slow = max(per_rank, key=lambda r: per_rank[r]["total_s"])
    segs = per_rank[slow]["phases_s"]
    others = [per_rank[r]["phases_s"] for r in per_rank if r != slow]
    best, lag = None, -1.0
    for name, dt in segs.items():
        base = min((o.get(name, 0.0) for o in others), default=0.0)
        if dt - base > lag:
            best, lag = name, dt - base
    return {"rank": slow, "total_s": per_rank[slow]["total_s"],
            "phase": best, "lag_s": max(0.0, lag),
            "per_rank": per_rank}


# ------------------------------------------- collective-time attribution

def collective_bytes_per_second(bytes_a, step_s_a, bytes_b, step_s_b):
    """Achieved bytes/s per mesh axis from a quant on/off (or any
    bytes-differing) twin pair: the per-axis byte delta over the
    measured step-time delta. `bytes_a`/`bytes_b` are per-axis byte
    dicts; side a is the SMALLER
    one (quant on). Axes whose bytes don't differ, or whose time delta
    is non-positive (noise swamped the signal), report None — honest
    about unattributable axes rather than inventing a rate."""
    dt = float(step_s_b) - float(step_s_a)
    out = {}
    for axis in sorted(set(bytes_a) | set(bytes_b)):
        db = float(bytes_b.get(axis, 0)) - float(bytes_a.get(axis, 0))
        if db <= 0 or dt <= 0:
            out[axis] = {"delta_bytes": int(db), "delta_s": dt,
                         "bytes_per_s": None}
        else:
            out[axis] = {"delta_bytes": int(db), "delta_s": dt,
                         "bytes_per_s": db / dt}
    return out


# ---------------------------------------------------------------- views

def phase_summary():
    """{phase: {count, sum, p50, p95, p99}} over the process-global
    pt_train_phase_seconds histogram — the training twin of
    reqtrace.phase_summary()."""
    out = {}
    for values, cell in _PHASE_SECONDS._series():
        s = summarize_histogram_cell(cell)
        if not s["count"]:
            continue
        out[values[0]] = {k: (round(v, 6) if isinstance(v, float)
                              else v) for k, v in s.items()}
    return out


# postmortems carry the recent step timelines next to the event ring
try:
    from . import flight_recorder as _fr

    _fr.add_state_provider("recent_steps", recent_steps)
except Exception:  # optional provider hookup at import
    pass
