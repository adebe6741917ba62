"""Tracing and step timing (counterpart of paddle_tpu/profiler; reference
python/paddle/profiler/profiler.py:310 `Profiler`, make_scheduler:136,
export_chrome_tracing:228, RecordEvent utils.py:33, timer.py).

The reference's API over `torch.profiler`: the host's operators and the
card's kernels (CUPTI) land in one chrome trace, written under the
trace directory when a recording window closes; `statistic.py` parses
that trace into the reference's per-op tables.

    prof = Profiler(scheduler=(2, 5),
                    on_trace_ready=export_chrome_tracing("./log"))
    prof.start()
    for batch in loader:
        train_step(batch)
        prof.step()
    prof.stop()
    prof.summary()

`RecordEvent` annotates a span on the host timeline
(`torch.profiler.record_function`). `benchmark()` is the global step
timer (reader cost, batch cost, ips): an armed meter is fed by
`jit.TrainStep` once a step, with the steptrace wall when the phase
plane is on, and hapi's `ProgBarLogger` reads it.
"""
import os
import time

import torch

from ..observability import metrics as _obs

__all__ = ["Profiler", "ProfilerState", "ProfilerTarget", "make_scheduler",
           "export_chrome_tracing", "RecordEvent", "benchmark"]

# the step timer mirrors every tick into the telemetry registry, so hapi's
# bar, raw loops around TrainStep and a /metrics scrape report the same
# reader-cost / batch-cost / ips numbers
_BATCH_COST = _obs.histogram("pt_step_batch_cost_seconds",
                             "per-step wall time (armed step timer)")
_READER_COST = _obs.histogram("pt_step_reader_cost_seconds",
                              "dataloader fetch time per batch")
_SAMPLES_TOTAL = _obs.counter("pt_step_samples_total",
                              "samples consumed by timed steps")


class ProfilerState:
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget:
    CPU = 0
    GPU = 1
    CUSTOM_DEVICE = 2
    TPU = 3


def make_scheduler(*, closed, ready, record, repeat=1, skip_first=0):
    """Step-state schedule (reference profiler.py:136): skip_first, then
    cycles of closed → ready → record."""
    cycle = closed + ready + record

    def schedule(step):
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat and s >= cycle * repeat:
            return ProfilerState.CLOSED
        pos = s % cycle
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == cycle - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return schedule


def export_chrome_tracing(dir_name, worker_name=None):
    """on_trace_ready factory: each recording window's chrome trace is
    written under `dir_name` as `<worker>.<ms>.pt.trace.json`."""

    def handler(prof):
        prof._trace_dir = dir_name
        prof._worker_name = worker_name

    handler._dir = dir_name
    return handler


class RecordEvent:
    """A user-scoped span on the host timeline (reference
    profiler/utils.py:33; here `torch.profiler.record_function`)."""

    def __init__(self, name, event_type=None):
        self.name = name
        self._rf = None

    def begin(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()

    def end(self):
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()


class _StepTimer:
    """reader / batch cost + ips (reference profiler/timer.py). `enable()`
    arms the global meter; an armed meter is fed by `jit.TrainStep`
    (one tick and the batch's sample count a step), so
    `benchmark().summary()` gives ips with no change to the loop."""

    def __init__(self):
        self.enabled = False
        self.reset()

    def reset(self):
        self.step_times = []
        self.reader_costs = []
        self.samples = 0
        self._t_last = None
        self.auto_fed = False   # True once an instrumented step ticked

    def enable(self):
        self.enabled = True
        self.reset()

    def disable(self):
        self.enabled = False

    def auto_step(self, num_samples=None, auto=True, dt=None):
        """A tick from an instrumented step (TrainStep). auto=False ticks
        without claiming the auto-fed flag: for a host-side ticker
        (hapi's ProgBarLogger over a loop no TrainStep feeds) that must
        stand down once an instrumented step feeds the meter. `dt` is a
        step wall measured outside (steptrace's anchor → opt_publish):
        with the phase plane on, TrainStep passes it, so this meter,
        hapi's bar and pt_train_phase_seconds agree."""
        if auto:
            self.auto_fed = True
        self.step(dt=dt)
        if num_samples:
            self.samples += int(num_samples)
            _SAMPLES_TOTAL.inc(int(num_samples))

    def summary(self):
        s = self.stats()
        if not s:
            return "no steps recorded"
        line = (f"avg batch cost {s['avg_batch_cost_s'] * 1e3:.2f} ms, "
                f"{s['steps_per_sec']:.2f} steps/s")
        if self.samples and self.step_times:
            ips = self.samples / sum(self.step_times)
            line += f", {ips:,.1f} ips"
        return line

    def before_reader(self):
        self._t_reader = time.perf_counter()

    def after_reader(self):
        dt = time.perf_counter() - getattr(self, "_t_reader",
                                           time.perf_counter())
        self.reader_costs.append(dt)
        _READER_COST.observe(dt)

    def step(self, dt=None):
        """One step tick. `dt=None` measures the wall since the last tick;
        an explicit dt records the caller's measurement."""
        now = time.perf_counter()
        if dt is not None:
            dt = float(dt)
            self.step_times.append(dt)
            _BATCH_COST.observe(dt)
        elif self._t_last is not None:
            dt = now - self._t_last
            self.step_times.append(dt)
            _BATCH_COST.observe(dt)
        self._t_last = now

    def stats(self, batch_size=None):
        if not self.step_times:
            return {}
        n = len(self.step_times)
        avg = sum(self.step_times) / n
        out = {"steps": n, "avg_batch_cost_s": avg,
               "steps_per_sec": 1.0 / avg if avg else float("inf")}
        if batch_size:
            out["ips"] = batch_size / avg
        if self.reader_costs:
            out["avg_reader_cost_s"] = (
                sum(self.reader_costs) / len(self.reader_costs))
        return out


_benchmark = _StepTimer()


def benchmark():
    """The global step timer (reference profiler/utils.py benchmark())."""
    return _benchmark


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class Profiler:
    """The reference's profiler over `torch.profiler`.

    scheduler: None (record from start() to stop()), an (on, off) batch
    tuple, or a make_scheduler callable. on_trace_ready: see
    export_chrome_tracing. timer_only=True traces nothing and only times
    steps."""

    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only=False, log_dir=None):
        if isinstance(scheduler, (tuple, list)):
            on, off = scheduler
            scheduler = make_scheduler(closed=on, ready=0, record=off - on,
                                       repeat=1)
        self._scheduler = scheduler
        self._on_trace_ready = on_trace_ready
        self.timer_only = timer_only
        self._trace_dir = log_dir or getattr(on_trace_ready, "_dir", None) \
            or "./profiler_log"
        self._worker_name = None
        self._step_no = 0
        self._prof = None
        self.timer = _StepTimer()

    # -- tracing control --
    def _trace_on(self):
        if self.timer_only or self._prof is not None:
            return
        self._prof = torch.profiler.profile(activities=_activities())
        self._prof.__enter__()

    def _trace_off(self):
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        if self._on_trace_ready is not None:
            self._on_trace_ready(self)
        os.makedirs(self._trace_dir, exist_ok=True)
        name = self._worker_name or f"host_{os.getpid()}"
        prof.export_chrome_trace(os.path.join(
            self._trace_dir,
            f"{name}.{int(time.time() * 1000)}.pt.trace.json"))

    def _apply_state(self):
        if self._scheduler is None:
            self._trace_on()
            return
        st = self._scheduler(self._step_no)
        if st in (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN):
            self._trace_on()
        else:
            self._trace_off()

    # -- reference API --
    def start(self):
        self.timer.reset()
        self.timer.step()  # arm the first interval
        self._apply_state()

    def stop(self):
        self._trace_off()

    def step(self, num_samples=None):
        self.timer.step()
        self._num_samples = num_samples
        self._step_no += 1
        self._apply_state()

    def step_info(self, unit=None):
        s = self.timer.stats(batch_size=getattr(self, "_num_samples", None))
        if not s:
            return "no steps recorded"
        ips = s.get("ips")
        return (f"batch_cost: {s['avg_batch_cost_s']:.5f} s "
                f"steps/s: {s['steps_per_sec']:.2f}"
                + (f" ips: {ips:.1f}" if ips else ""))

    def statistic_data(self):
        """Per-op statistics parsed from the newest trace under the trace
        directory (reference profiler_statistic.py StatisticData), or None
        when nothing was recorded."""
        if self.timer_only:
            return None
        from . import statistic

        collected = statistic.collect(self._trace_dir)
        if collected is None:
            return None
        return statistic.build_tables(collected)

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms", views=None, max_rows=30):
        """Print the step timer's line and the reference-style per-op
        tables of the trace (device lanes: the card's kernels, copies and
        sets; host lanes: operators, runtime calls, RecordEvent spans)."""
        print(self.step_info())
        data = self.statistic_data()
        if data is None:
            if not self.timer_only:
                print(f"no parsed trace found under {self._trace_dir}")
            return None
        from . import statistic

        order = {None: "total", SortedKeys.OpTotal: "total",
                 SortedKeys.OpAvg: "avg", SortedKeys.OpMax: "max",
                 "total": "total", "avg": "avg", "max": "max",
                 "calls": "calls"}.get(sorted_by, "total")
        print(statistic.render(data, sorted_by=order, max_rows=max_rows))
        return data

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


class SortedKeys:
    """Sort orders for summary tables (reference profiler.py SortedKeys)."""

    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7
    # aliases used by summary(): device lanes, host lanes
    OpTotal = 0
    OpAvg = 1
    OpMax = 2


class SummaryView:
    """Summary table views (reference profiler.py SummaryView)."""

    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6
    MemoryManipulationView = 7
    UDFView = 8


class TracerEventType:
    """Event categories (reference profiler_statistic.py)."""

    Operator = 0
    Dataloader = 1
    ProfileStep = 2
    CudaRuntime = 3
    Kernel = 4
    Memcpy = 5
    Memset = 6
    UserDefined = 7
    OperatorInner = 8
    Forward = 9
    Backward = 10
    Optimization = 11
    Communication = 12
    PythonOp = 13
    PythonUserDefined = 14


def export_protobuf(dir_name, worker_name=None):
    """on_trace_ready exporter: the trace directory (torch writes chrome
    traces; there is no protobuf dump)."""

    def handler(prof):
        return dir_name

    return handler


def load_profiler_result(file_name):
    """A written trace's path, for post-processing (`statistic.collect`
    parses the newest one under a directory)."""
    if not os.path.exists(file_name):
        raise FileNotFoundError(file_name)
    return file_name


__all__ += ["SortedKeys", "SummaryView", "TracerEventType",
            "export_protobuf", "load_profiler_result"]
