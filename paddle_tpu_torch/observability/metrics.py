"""Process-wide metrics registry: Counter / Gauge / Histogram with labels
(counterpart of paddle_tpu/observability/metrics.py, the port's own copy:
the port's registry is separate from the JAX package's, so a process that
imports both holds two registries and nothing crosses between them).

The measurement substrate every runtime layer shares (reference: the
monitor stats + benchmark timer scattered through the reference's
profiler/ and fluid monitors; here ONE registry instead of per-module
``stats`` dicts). Metric objects are cheap process-globals created at
import time; instrumented code calls ``.inc()`` / ``.set()`` /
``.observe()`` unconditionally and the registry decides whether anything
happens:

* mode ``off``    (``PT_TELEMETRY=0``)  — every write is a no-op behind a
  single attribute check (the overhead test pins this path).
* mode ``metrics`` (default)            — counting is live. Writes are
  LOCK-FREE: each metric child keeps per-thread cells keyed by thread id
  (a thread only ever mutates its own cell, and CPython dict get/set are
  single bytecodes), so concurrent increments never lose updates and the
  hot path takes no lock. Snapshots merge the cells.
* mode ``full``   (``PT_TELEMETRY=1``)  — same counting, plus span
  tracing and at-exit exporters (see ``tracing.py`` / package __init__).

Exporters: ``snapshot()`` (nested dict), ``to_prometheus()``
(text-format 0.0.4), ``to_jsonl()`` (one JSON object per series).
Histograms expose ``quantile(q)`` via linear interpolation over their
bucket counts.

Label cardinality is capped per metric (``max_series``): past the cap
new label combinations collapse into one ``__overflow__`` series (and a
one-time warning) instead of growing without bound or crashing a hot
path — the failure mode of label-by-request-id mistakes.
"""
import bisect
import json
import os
import threading
import warnings
from threading import get_ident

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
           "counter", "gauge", "histogram", "snapshot", "to_prometheus",
           "to_jsonl", "DEFAULT_BUCKETS"]


class _State:
    """Telemetry mode shared by metrics and tracing.

    0 = off (no-op), 1 = metrics only (default), 2 = full (+ tracing,
    + at-exit export). Resolved once from PT_TELEMETRY; tests flip it
    via observability.set_mode().
    """

    __slots__ = ("mode",)

    OFF, METRICS, FULL = 0, 1, 2

    def __init__(self):
        v = os.environ.get("PT_TELEMETRY", "").strip().lower()
        if v in ("0", "off", "false", "no"):
            self.mode = self.OFF
        elif v in ("", "metrics", "count", "counters"):
            # the mode NAMES are accepted too, so PT_TELEMETRY=metrics
            # means counting-only (not silently full)
            self.mode = self.METRICS
        else:
            self.mode = self.FULL


_STATE = _State()

# seconds-scale duration buckets: 100 µs … 5 min + overflow
DEFAULT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                   30.0, 60.0, 120.0, 300.0)


# ----------------------------------------------------------------- children

class _CounterCell:
    """One monotonic counter series. Lock-free: per-thread cells.

    always=True exempts the cell from off-mode gating — for counters
    that back a PRE-EXISTING accounting API (xproc.stats) whose
    consumers predate the telemetry gate and must keep counting under
    PT_TELEMETRY=0."""

    __slots__ = ("_cells", "_always")

    def __init__(self, always=False):
        self._cells = {}
        self._always = always

    def inc(self, n=1):
        if _STATE.mode == 0 and not self._always:
            return
        cells = self._cells
        tid = get_ident()
        cells[tid] = cells.get(tid, 0) + n

    @property
    def value(self):
        return sum(list(self._cells.values()))


class _GaugeCell:
    """Last-write-wins instantaneous value (a float store is atomic
    under the GIL, so no cells are needed)."""

    __slots__ = ("_v",)

    def __init__(self):
        self._v = 0.0

    def set(self, v):
        if _STATE.mode == 0:
            return
        self._v = float(v)

    def inc(self, n=1):
        if _STATE.mode == 0:
            return
        self._v += n          # convenience; not for cross-thread counting

    def dec(self, n=1):
        self.inc(-n)

    @property
    def value(self):
        return self._v


class _HistogramCell:
    """Bucketed distribution. Per-thread cells of
    [bucket_counts, sum, count]; merged at snapshot time."""

    __slots__ = ("_bounds", "_cells")

    def __init__(self, bounds):
        self._bounds = bounds
        self._cells = {}

    def observe(self, x):
        if _STATE.mode == 0:
            return
        tid = get_ident()
        cell = self._cells.get(tid)
        if cell is None:
            cell = self._cells[tid] = [[0] * (len(self._bounds) + 1),
                                       0.0, 0]
        cell[0][bisect.bisect_left(self._bounds, x)] += 1
        cell[1] += x
        cell[2] += 1

    def merged(self):
        counts = [0] * (len(self._bounds) + 1)
        total, n = 0.0, 0
        for cell in list(self._cells.values()):
            for i, c in enumerate(list(cell[0])):
                counts[i] += c
            total += cell[1]
            n += cell[2]
        return counts, total, n

    @property
    def count(self):
        return self.merged()[2]

    @property
    def sum(self):
        return self.merged()[1]

    def quantile(self, q):
        """Linear interpolation inside the bucket holding rank q·n.
        Returns 0.0 with no observations; the overflow bucket answers
        with the largest finite bound."""
        counts, _, n = self.merged()
        if n == 0:
            return 0.0
        rank = q * n
        cum = 0
        for i, c in enumerate(counts):
            prev_cum = cum
            cum += c
            if cum >= rank and c > 0:
                if i >= len(self._bounds):          # overflow bucket
                    return float(self._bounds[-1])
                lo = self._bounds[i - 1] if i > 0 else 0.0
                hi = self._bounds[i]
                frac = (rank - prev_cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        return float(self._bounds[-1])


def summarize_histogram_cell(cell):
    """{count, sum, p50, p95, p99} for one histogram cell — the ONE
    percentile-view shape (`Histogram.summary()` for unlabeled
    histograms, `reqtrace.phase_summary()` per label)."""
    _counts, total, n = cell.merged()
    return {"count": n, "sum": total,
            "p50": cell.quantile(0.50),
            "p95": cell.quantile(0.95),
            "p99": cell.quantile(0.99)}


_CELL_TYPES = {"counter": _CounterCell, "gauge": _GaugeCell,
               "histogram": _HistogramCell}


# ------------------------------------------------------------------ metrics

class _Metric:
    """Shared parent machinery: an unlabeled metric proxies straight to
    its single cell; a labeled one vends children via .labels()."""

    kind = None

    def __init__(self, name, help="", labelnames=(), max_series=512,
                 **cell_kw):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.max_series = int(max_series)
        self._cell_kw = cell_kw
        self._children = {}
        self._lock = threading.Lock()      # child creation only
        self._overflow = None
        self._warned = False
        if not self.labelnames:
            self._default = self._make_cell()
        else:
            self._default = None

    def _make_cell(self):
        return _CELL_TYPES[self.kind](**self._cell_kw)

    def labels(self, *values, **kv):
        if kv:
            try:
                values = tuple(kv[k] for k in self.labelnames)
            except KeyError as e:
                raise ValueError(
                    f"{self.name}: unknown label {e} "
                    f"(expects {self.labelnames})") from e
        else:
            values = tuple(values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: got {len(values)} label values, expects "
                f"{self.labelnames}")
        values = tuple(str(v) for v in values)
        child = self._children.get(values)
        if child is not None:
            return child
        with self._lock:
            child = self._children.get(values)
            if child is not None:
                return child
            if len(self._children) >= self.max_series:
                # cardinality blowout: collapse instead of growing or
                # raising from a hot path
                if not self._warned:
                    self._warned = True
                    warnings.warn(
                        f"metric {self.name} exceeded max_series="
                        f"{self.max_series}; new label sets collapse "
                        "into '__overflow__'", RuntimeWarning,
                        stacklevel=2)
                if self._overflow is None:
                    self._overflow = self._make_cell()
                    self._children[
                        ("__overflow__",) * len(self.labelnames)
                    ] = self._overflow
                return self._overflow
            child = self._make_cell()
            self._children[values] = child
            return child

    def _series(self):
        """[(label_values_tuple, cell)] — () key for the unlabeled cell."""
        if self._default is not None:
            return [((), self._default)]
        return list(self._children.items())

    def remove(self, *values, **kv):
        """Drop one label series (e.g. a departed rank's gauge) so it
        stops being exported as if still live. No-op if absent."""
        if kv:
            values = tuple(str(kv[k]) for k in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        with self._lock:
            self._children.pop(values, None)

    # unlabeled proxying -------------------------------------------------
    def _cell(self):
        if self._default is None:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; call "
                ".labels(...) first")
        return self._default


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help="", labelnames=(), max_series=512,
                 always_on=False):
        super().__init__(name, help, labelnames, max_series,
                         always=always_on)

    def inc(self, n=1):
        self._cell().inc(n)

    @property
    def value(self):
        return self._cell().value


class Gauge(_Metric):
    kind = "gauge"

    def set(self, v):
        self._cell().set(v)

    def inc(self, n=1):
        self._cell().inc(n)

    def dec(self, n=1):
        self._cell().dec(n)

    @property
    def value(self):
        return self._cell().value


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help="", labelnames=(), max_series=512,
                 buckets=None):
        bounds = tuple(sorted(buckets or DEFAULT_BUCKETS))
        super().__init__(name, help, labelnames, max_series,
                         bounds=bounds)
        self.buckets = bounds

    def observe(self, x):
        self._cell().observe(x)

    def quantile(self, q):
        return self._cell().quantile(q)

    def summary(self):
        """{count, sum, p50, p95, p99} for the (unlabeled) series —
        the one-call percentile view for consumers holding a histogram
        handle (labeled histograms: summarize each `_series()` cell
        via `summarize_histogram_cell`, as reqtrace.phase_summary
        does)."""
        return summarize_histogram_cell(self._cell())

    @property
    def count(self):
        return self._cell().count

    @property
    def sum(self):
        return self._cell().sum


# ----------------------------------------------------------------- registry

def _escape_label(v):
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _fmt_labels(names, values, extra=()):
    pairs = [f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_escape_label(str(v))}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _fmt_num(v):
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


class MetricsRegistry:
    """name → metric. get-or-create accessors enforce one (type,
    labelnames) per name, so two modules asking for the same counter
    share one series family."""

    def __init__(self):
        self._metrics = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        m = self._metrics.get(name)
        if m is None:
            # construct OUTSIDE the lock: the metric class arrives as
            # an argument, and caller-visible code under the registry
            # lock is a re-entrancy hazard; a losing racer
            # just discards its fresh instance
            fresh = cls(name, help=help, labelnames=labelnames, **kw)
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    self._metrics[name] = fresh
                    return fresh
        if not isinstance(m, cls) or m.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name} already registered as {m.kind}"
                f"{m.labelnames}; requested {cls.kind}{tuple(labelnames)}")
        return m

    def counter(self, name, help="", labelnames=(), **kw):
        return self._get_or_create(Counter, name, help, labelnames, **kw)

    def gauge(self, name, help="", labelnames=(), **kw):
        return self._get_or_create(Gauge, name, help, labelnames, **kw)

    def histogram(self, name, help="", labelnames=(), **kw):
        return self._get_or_create(Histogram, name, help, labelnames, **kw)

    def get(self, name):
        return self._metrics.get(name)

    def __iter__(self):
        return iter(list(self._metrics.values()))

    def reset(self):
        """Drop every registered metric (tests; never in production —
        module-level metric handles keep working because instrumented
        code re-fetches by name or holds the object, whose cells simply
        stop being reported)."""
        with self._lock:
            self._metrics.clear()

    # ---- exporters ----
    def snapshot(self):
        """{name: {"type", "help", "series": [{labels, ...values}]}}."""
        out = {}
        for m in self:
            series = []
            for values, cell in m._series():
                labels = dict(zip(m.labelnames, values))
                if m.kind == "histogram":
                    counts, total, n = cell.merged()
                    series.append({
                        "labels": labels, "count": n, "sum": total,
                        "buckets": dict(zip(
                            [str(b) for b in m.buckets] + ["+Inf"],
                            counts)),
                        "p50": cell.quantile(0.50),
                        "p95": cell.quantile(0.95),
                        "p99": cell.quantile(0.99)})
                else:
                    series.append({"labels": labels, "value": cell.value})
            out[m.name] = {"type": m.kind, "help": m.help,
                           "series": series}
        return out

    def to_prometheus(self):
        """Prometheus text exposition format 0.0.4. Each histogram is
        followed by a `{name}_quantile` GAUGE family (p50/p95/p99 by a
        `quantile` label), so scrapers (and the bench stamps / router
        load view) read percentiles directly instead of re-deriving
        them from bucket counts — a SEPARATE family emitted after the
        histogram's own, because foreign samples inside a
        `# TYPE ... histogram` block violate the exposition format and
        split the family in spec parsers (verified against
        prometheus_client's reference parser)."""
        lines = []
        for m in self:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            ptype = m.kind
            lines.append(f"# TYPE {m.name} {ptype}")
            qlines = []
            for values, cell in m._series():
                if m.kind == "histogram":
                    counts, total, n = cell.merged()
                    cum = 0
                    for b, c in zip(list(m.buckets) + ["+Inf"], counts):
                        cum += c
                        lines.append(
                            f"{m.name}_bucket"
                            f"{_fmt_labels(m.labelnames, values, [('le', b)])}"
                            f" {cum}")
                    lab = _fmt_labels(m.labelnames, values)
                    lines.append(f"{m.name}_sum{lab} {_fmt_num(total)}")
                    lines.append(f"{m.name}_count{lab} {n}")
                    for q in (0.5, 0.95, 0.99):
                        qlab = _fmt_labels(m.labelnames, values,
                                           [("quantile", q)])
                        qlines.append(
                            f"{m.name}_quantile{qlab} "
                            f"{_fmt_num(cell.quantile(q))}")
                else:
                    lab = _fmt_labels(m.labelnames, values)
                    lines.append(f"{m.name}{lab} {_fmt_num(cell.value)}")
            if qlines:
                lines.append(f"# TYPE {m.name}_quantile gauge")
                lines += qlines
        return "\n".join(lines) + "\n"

    def to_jsonl(self):
        """One JSON object per series (the journal-friendly dump)."""
        lines = []
        for name, entry in self.snapshot().items():
            for s in entry["series"]:
                rec = {"metric": name, "type": entry["type"]}
                rec.update(s)
                lines.append(json.dumps(rec))
        return "\n".join(lines) + ("\n" if lines else "")

    def compact(self, skip_zero=True):
        """Flat {'name{k=v}': value} view of counters/gauges plus
        {count,sum,p50,p99} for histograms — the shape bench stamps and
        the anomaly journal carries."""
        out = {}
        for m in self:
            for values, cell in m._series():
                key = m.name + _fmt_labels(m.labelnames, values)
                if m.kind == "histogram":
                    counts, total, n = cell.merged()
                    if n == 0 and skip_zero:
                        continue
                    out[key] = {"count": n, "sum": round(total, 6),
                                "p50": round(cell.quantile(0.5), 6),
                                "p95": round(cell.quantile(0.95), 6),
                                "p99": round(cell.quantile(0.99), 6)}
                else:
                    v = cell.value
                    if v == 0 and skip_zero:
                        continue
                    out[key] = int(v) if float(v).is_integer() else v
        return out


_REGISTRY = MetricsRegistry()


def registry():
    """The process-wide default registry."""
    return _REGISTRY


def counter(name, help="", labelnames=(), **kw):
    return _REGISTRY.counter(name, help, labelnames, **kw)


def gauge(name, help="", labelnames=(), **kw):
    return _REGISTRY.gauge(name, help, labelnames, **kw)


def histogram(name, help="", labelnames=(), **kw):
    return _REGISTRY.histogram(name, help, labelnames, **kw)


def snapshot():
    return _REGISTRY.snapshot()


def to_prometheus():
    return _REGISTRY.to_prometheus()


def to_jsonl():
    return _REGISTRY.to_jsonl()
