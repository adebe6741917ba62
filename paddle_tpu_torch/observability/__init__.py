"""Observability (counterpart of paddle_tpu/observability): the port's
own metrics registry (`metrics`), span tracer (`tracing`), request
traces (`reqtrace`), failure flight recorder (`flight_recorder`) and
the train-step FLOPs accountant (`steptrace`). The telemetry mode comes
from ``PT_TELEMETRY`` (0 off, unset metrics, 1 full), as in the
reference. The HTTP ``/metrics`` endpoint and the at-exit telemetry
export are not ported yet (ROADMAP A10b)."""
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
           "start_http_server", "TraceContext", "new_trace", "reqtrace",
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
    return prev


def metrics_enabled():
    return _STATE.mode >= _STATE.METRICS


def full_enabled():
    return _STATE.mode >= _STATE.FULL


def start_http_server(*a, **kw):
    raise NotImplementedError(
        "the /metrics HTTP endpoint is not ported yet: ROADMAP A10b "
        "(HTTP endpoint and telemetry export)")
