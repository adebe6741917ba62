"""The port's observability (metrics registry, span tracer, request
traces, flight recorder) and chaos plan against the JAX package's on CPU.

The same writes into a fresh registry of each package give the same
Prometheus text, JSON snapshot, JSONL and compact view; the two
packages' process registries are separate objects. A `TraceContext` wire
dict round-trips between the packages with its stamps, parent and quiet
flag. Flight-recorder dumps of the same events carry the same contents.
A chaos plan gives the same schedule and the same fired calls. Plus the
reference's registry cases (labels, conflicts, cardinality collapse,
quantiles, concurrent increments, off mode) and the engine's phases
summing to its TTFT.
"""
import json
import threading

import numpy as np
import pytest
import torch

from paddle_tpu import observability as jobs
from paddle_tpu.distributed import chaos as jchaos
from paddle_tpu.observability import flight_recorder as jfr
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import reqtrace as jreq
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.distributed import chaos as tchaos
from paddle_tpu_torch.inference import llm_engine as teng
from paddle_tpu_torch.observability import flight_recorder as tfr
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.observability import reqtrace as treq
from paddle_tpu_torch.observability import tracing as ttracing
from paddle_tpu_torch.text.models.gpt import GPTForCausalLM, gpt_tiny

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes at once, and torch's thread pool oversubscribes the
    cores then (small ops slow down tenfold); results do not change."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def modes():
    """Both packages in metrics mode for the test, restored after."""
    prev = (jobs.mode(), tobs.mode())
    jobs.set_mode("metrics")
    tobs.set_mode("metrics")
    yield
    jobs.set_mode(prev[0])
    tobs.set_mode(prev[1])
    ttracing.reset()


def _writes(reg):
    """One fixed sequence of writes, the same for either package."""
    c = reg.counter("pt_x_total", "a counter", labelnames=("op", "kind"))
    c.labels(op="a", kind="k").inc()
    c.labels("a", "k").inc(2)
    c.labels(op="b", kind='q"x\n').inc(5)
    reg.counter("pt_plain_total", "plain").inc(7)
    g = reg.gauge("pt_g", "a gauge")
    g.set(2.5)
    g.inc(1)
    g.dec(0.25)
    reg.gauge("pt_lg", "labeled", labelnames=("replica",)).labels(
        replica="r0").set(3)
    h = reg.histogram("pt_h_seconds", "a histogram",
                      buckets=(0.001, 0.01, 0.1, 1.0))
    for x in (0.0005, 0.002, 0.002, 0.05, 0.5, 3.0):
        h.observe(x)
    hl = reg.histogram("pt_hl", "labeled histogram", labelnames=("phase",))
    for i, x in enumerate((0.0002, 0.03, 0.3, 7.0, 40.0)):
        hl.labels(phase=f"p{i % 2}").observe(x)
    reg.histogram("pt_empty", "never observed")
    capped = reg.counter("pt_card_total", labelnames=("k",), max_series=3)
    with pytest.warns(RuntimeWarning):
        for i in range(6):
            capped.labels(k=str(i)).inc()


def test_registry_exports_match_reference(modes):
    jr, tr = jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
    _writes(jr)
    _writes(tr)
    assert tr.to_prometheus() == jr.to_prometheus()
    assert tr.snapshot() == jr.snapshot()
    assert json.dumps(tr.snapshot(), sort_keys=True) == json.dumps(
        jr.snapshot(), sort_keys=True)
    assert tr.to_jsonl() == jr.to_jsonl()
    assert tr.compact() == jr.compact()
    assert tr.compact(skip_zero=False) == jr.compact(skip_zero=False)


def test_process_registries_are_separate():
    assert tmetrics.registry() is not jmetrics.registry()
    name = "pt_torch_port_only_total"
    tmetrics.counter(name, "port only")
    assert tmetrics.registry().get(name) is not None
    assert jmetrics.registry().get(name) is None


def test_histogram_summaries_match_reference(modes):
    for bounds in ((1.0, 10.0), tmetrics.DEFAULT_BUCKETS):
        hs = (jmetrics.Histogram("h", buckets=bounds),
              tmetrics.Histogram("h", buckets=bounds))
        rng = np.random.default_rng(1)
        for x in rng.exponential(0.5, 200):
            for h in hs:
                h.observe(float(x))
        assert hs[1].summary() == hs[0].summary()
        for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
            assert hs[1].quantile(q) == hs[0].quantile(q)
        assert tmetrics.summarize_histogram_cell(hs[1]._cell()) == \
            jmetrics.summarize_histogram_cell(hs[0]._cell())


def test_counter_gauge_histogram_basics(modes):
    reg = tmetrics.MetricsRegistry()
    c = reg.counter("c_total", "help text", labelnames=("op",))
    c.labels(op="a").inc()
    c.labels(op="a").inc(2)
    c.labels("b").inc()
    assert c.labels(op="a").value == 3 and c.labels(op="b").value == 1
    h = reg.histogram("h", buckets=(1.0, 10.0))
    for x in (0.5, 5.0, 50.0):
        h.observe(x)
    assert h.count == 3 and h.sum == 55.5
    with pytest.raises(ValueError):
        reg.gauge("c_total")
    with pytest.raises(ValueError):
        reg.counter("c_total", labelnames=("other",))
    assert reg.counter("c_total", labelnames=("op",)) is c
    with pytest.raises(ValueError):
        c.inc()                     # labeled: needs .labels()
    with pytest.raises(ValueError, match="unknown label"):
        c.labels(nope="x")


def test_concurrent_increments_are_exact(modes):
    c = tmetrics.MetricsRegistry().counter("cc_total")

    def work():
        for _ in range(5000):
            c.inc()

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == 40000


def test_off_mode_is_a_noop_and_env_parse(monkeypatch, modes):
    c = tmetrics.MetricsRegistry().counter("off_total")
    tobs.set_mode("off")
    c.inc()
    assert c.value == 0 and tfr.dump("manual") is None
    tobs.set_mode("metrics")
    c.inc()
    assert c.value == 1
    for env, want in (("0", 0), ("off", 0), ("", 1), ("metrics", 1),
                      ("1", 2), ("full", 2)):
        monkeypatch.setenv("PT_TELEMETRY", env)
        assert tmetrics._State().mode == want == jmetrics._State().mode
    with pytest.raises(ValueError):
        tobs.set_mode("loud")
    http = tobs.start_http_server()     # serves in every mode
    try:
        assert http.host == "127.0.0.1" and http.port > 0
    finally:
        http.stop()


# ---- request traces ----

def test_trace_context_wire_dict_crosses_both_ways(modes):
    for src_mod, dst_mod in ((jreq, treq), (treq, jreq)):
        ctx = src_mod.TraceContext(parent_id="p0")
        for i, ph in enumerate(("queued", "routed", "prefill_start",
                                "prefill_end", "kv_export")):
            ctx.stamp(ph, t=1000.0 + 0.25 * i)
        wire = ctx.to_dict()
        back = dst_mod.TraceContext.from_dict(wire)
        assert back.to_dict() == wire
        assert set(wire) == {"trace_id", "parent_id", "quiet", "phases"}
        assert back.timeline() == ctx.timeline()
        assert back.total_s() == ctx.total_s()
        # the next stamp measures from the exporter's last one
        back.stamp("kv_import", t=1002.0)
        assert back.timeline()[-1]["dt_s"] == pytest.approx(1.0)
        assert back.stamp("kv_import") is False      # first wins
        q = dst_mod.TraceContext.from_dict(
            src_mod.quiet_trace().to_dict())
        assert q.quiet is True


def test_phase_segments_feed_the_histogram_and_the_ring(modes):
    ctx = treq.new_trace()
    before = {k: v["count"] for k, v in treq.phase_summary().items()}
    ctx.stamp("queued", t=10.0)
    ctx.stamp("prefill_start", t=10.5)
    ctx.stamp("first_token", t=11.0)
    after = treq.phase_summary()
    for ph in ("prefill_start", "first_token"):
        assert after[ph]["count"] == before.get(ph, 0) + 1
    evs = [e for e in tfr.recorder().events("request_phase")
           if e["trace_id"] == ctx.trace_id]
    assert [e["phase"] for e in evs] == ["prefill_start", "first_token"]
    quiet = treq.quiet_trace()
    quiet.stamp("queued", t=1.0)
    quiet.stamp("first_token", t=2.0)
    assert treq.phase_summary()["first_token"]["count"] == \
        after["first_token"]["count"]


def test_engine_request_phases_sum_to_ttft(modes):
    tm = GPTForCausalLM(gpt_tiny(), device="cpu", seed=3)
    eng = teng.LLMEngine(tm, teng.LLMEngineConfig(num_slots=2,
                                                  max_model_len=64))
    req = eng.add_request(np.arange(20) % 7, max_new_tokens=4)
    while eng.has_work():
        eng.step()
    tl = req.trace.timeline()
    names = [p["phase"] for p in tl]
    assert names[0] == "queued" and "first_token" in names
    assert names.index("prefill_start") < names.index("first_token")
    assert sum(p["dt_s"] for p in tl) == pytest.approx(
        req.trace.total_s(), abs=1e-9)
    recent = eng.metrics()["recent_requests"]
    assert recent and recent[-1]["trace_id"] == req.trace.trace_id


# ---- span tracer ----

def test_spans_full_mode_identity_and_sinks(modes):
    seen = []
    ttracing.add_sink(seen.append)
    tobs.set_mode("full")
    try:
        ttracing.reset()
        ttracing.set_replica("r7")
        ctx = treq.new_trace()
        with ttracing.ambient_trace(ctx):
            with ttracing.trace_span("outer", a=1):
                with ttracing.trace_span("inner"):
                    pass
        with pytest.raises(KeyError):
            with ttracing.trace_span("bad"):
                raise KeyError("x")
        ttracing.add_event("phase.x", 5, 7, args={"k": 1})
        ttracing.set_replica(None)
        evs = ttracing.chrome_events()
        assert [e["name"] for e in evs] == ["inner", "outer", "bad",
                                            "phase.x"]
        assert all(e["ph"] == "X" and e["replica"] == "r7" for e in evs)
        assert evs[1]["args"] == {"a": 1, "trace_id": ctx.trace_id}
        assert evs[2]["args"]["error"] == "KeyError"
        assert evs[3]["ts"] == 5 and evs[3]["dur"] == 7
        assert seen[-4:] == evs
        assert ttracing.current_replica() is None
    finally:
        ttracing.remove_sink(seen.append)
        tobs.set_mode("metrics")
    ttracing.reset()
    with ttracing.trace_span("quiet"):
        pass
    assert ttracing.chrome_events() == []    # below full mode: nothing


def test_span_annotation_enters_record_function(modes, monkeypatch):
    """PT_TRACE_ANNOTATE=1 wraps each span in
    torch.profiler.record_function (the reference's TraceAnnotation),
    so a profiler capture sees the span by name."""
    import torch

    monkeypatch.setenv("PT_TRACE_ANNOTATE", "1")
    tobs.set_mode("full")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with ttracing.trace_span("pt_span_probe"):
            torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert "pt_span_probe" in names


# ---- flight recorder ----

def _record(fr):
    fr.record("request_phase", trace_id="t1", phase="prefill_end",
              dur_s=0.5)
    fr.record("failover_requeue", rid=3, trace_id="t2", attempt=1)
    fr.add_state_provider("router", lambda: {"inflight": 2,
                                             "replicas": {"a": True}})
    fr.add_state_provider("sick", lambda: 1 / 0)


def test_flight_recorder_dump_matches_reference(modes, tmp_path):
    dumps = []
    for mod, sub in ((jfr, "j"), (tfr, "t")):
        fr = mod.FlightRecorder(capacity=8)
        _record(fr)
        path = fr.dump("replica_death", directory=str(tmp_path / sub),
                       replica="a", requeued=[{"rid": 3}])
        assert path is not None and path.endswith(
            "postmortem.rank0.0.replica_death.json")
        with open(path) as f:
            dumps.append(json.load(f))
        fr.remove_state_provider("router")
    jd, td = dumps
    assert set(td) == set(jd)
    for key in ("reason", "rank", "context", "states"):
        assert td[key] == jd[key], key
    strip = [{k: v for k, v in e.items() if k != "t"} for e in td["events"]]
    assert strip == [{k: v for k, v in e.items() if k != "t"}
                     for e in jd["events"]]
    assert "sick" in td["states"] and "error" in td["states"]["sick"]


def test_flight_recorder_ring_is_bounded(modes):
    fr = tfr.FlightRecorder(capacity=4)
    for i in range(10):
        fr.record("e", i=i)
    assert [e["i"] for e in fr.events()] == [6, 7, 8, 9]
    assert fr.events("other") == []
    assert fr.dump("manual") is None     # no directory, metrics mode
    fr.clear()
    assert fr.events() == []


# ---- chaos ----

PLAN = {"seed": 11, "injectors": [
    {"scope": "replica.kill.a", "kind": "error", "at": [3, 9]},
    {"scope": "replica.kill", "kind": "error", "p": 0.2, "max_fires": 2},
    {"scope": "replica.kill.b", "kind": "delay", "p": 0.5,
     "delay_s": 0.0}]}


def test_chaos_plan_fires_as_the_reference(modes):
    for scope in ("replica.kill", "replica.kill.a", "replica.kill.b"):
        assert (tchaos.FaultPlan.from_json(json.dumps(PLAN)).schedule(
            scope, 50, rank=0) == jchaos.FaultPlan.from_json(
                json.dumps(PLAN)).schedule(scope, 50, rank=0))
    tplan = tchaos.FaultPlan.from_json(json.dumps(PLAN))
    jplan = jchaos.FaultPlan.from_json(json.dumps(PLAN))
    assert tplan.to_json() == jplan.to_json()
    for _ in range(30):
        for scope in ("replica.kill", "replica.kill.a", "replica.kill.b"):
            outs = []
            for plan, mod in ((tplan, tchaos), (jplan, jchaos)):
                try:
                    inj = plan.fire(scope)
                    outs.append(None if inj is None else inj.kind)
                except mod.InjectedFault as e:
                    outs.append(("raised", e.scope, e.n))
            assert outs[0] == outs[1]
    assert tplan.injected == jplan.injected
    assert isinstance(tchaos.InjectedFault("s", 1), OSError)
    # as in the reference, an injection is an anomaly-journal event,
    # which the journal mirrors into the flight recorder's ring
    evs = [e["entry"] for e in tfr.recorder().events("journal")
           if e["entry"]["kind"] == "chaos_injected"]
    assert evs and evs[-1]["scope"].startswith("replica.kill")


def test_chaos_install_clear_and_poison():
    tchaos.clear()
    assert not tchaos.active() and tchaos.fire("replica.kill") is None
    tchaos.install({"seed": 0, "injectors": [
        {"scope": "step.nan", "kind": "nan", "at": [1]}]})
    try:
        assert tchaos.active()
        assert tchaos.poison(1.0) == 1.0
        assert np.isnan(tchaos.poison(1.0))
    finally:
        tchaos.clear()
    assert tchaos.get_plan() is None


# ---- telemetry export and the HTTP endpoint ----

def test_export_all_and_journal_snapshot_match_reference(tmp_path,
                                                          monkeypatch,
                                                          modes):
    """`export_all` writes the registry's Prometheus text and JSON
    snapshot under the reference's file names and folds a compact
    snapshot into the anomaly journal, whose JSONL file has the
    reference's name and line layout."""
    from paddle_tpu.distributed import resilience as jres
    from paddle_tpu_torch.distributed import resilience as tres

    monkeypatch.setenv("PT_ANOMALY_DIR", str(tmp_path / "journal"))
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    tres.reset()
    jres.reset()
    try:
        tmetrics.registry().counter(
            "pt_export_probe_total", "export probe").inc(4)
        d = tobs.export_all(str(tmp_path / "tel"))
        names = sorted(p.name for p in (tmp_path / "tel").iterdir())
        assert d == str(tmp_path / "tel")
        assert "metrics.rank3.prom" in names
        assert "metrics.rank3.json" in names
        text = (tmp_path / "tel" / "metrics.rank3.prom").read_text()
        assert "pt_export_probe_total 4" in text
        snap = json.loads((tmp_path / "tel" / "metrics.rank3.json")
                          .read_text())
        assert snap["pt_export_probe_total"]["series"][0]["value"] == 4
        ev = tres.events("telemetry_snapshot")[-1]
        assert ev["note"] == "export_all" and ev["rank"] == 3
        assert ev["metrics"]["pt_export_probe_total"] == 4
        entry = tobs.journal_snapshot(note="manual")
        jentry = jobs.journal_snapshot(note="manual")
        assert set(entry) == set(jentry)
        lines = (tmp_path / "journal" / "anomalies.rank3.jsonl"
                 ).read_text().strip().splitlines()
        kinds = [json.loads(x)["kind"] for x in lines]
        assert kinds.count("telemetry_snapshot") == 3   # both packages
        assert set(json.loads(lines[-1])) == set(json.loads(lines[-2]))
        assert tobs.bench_snapshot()["pt_export_probe_total"] == 4
        assert tobs.telemetry_dir() == jobs.telemetry_dir()
    finally:
        tres.reset()
        jres.reset()


def test_export_replica_names_a_file_per_replica(tmp_path, modes):
    paths = [tobs.export_replica(name, lambda n=name: {"who": n},
                                 directory=str(tmp_path))
             for name in ("r/0", "r 1")]
    assert [p.rsplit("/", 1)[1] for p in paths] == [
        "metrics.rank0.r_0.json", "metrics.rank0.r_1.json"]
    ref = jobs.export_replica("r/0", lambda: {"who": "r/0"},
                              directory=str(tmp_path / "ref"))
    assert ref.rsplit("/", 1)[1] == "metrics.rank0.r_0.json"
    mine = json.loads(open(paths[0]).read())
    theirs = json.loads(open(ref).read())
    assert set(mine) == set(theirs) == {"replica", "view", "metrics"}
    assert mine["view"] == {"who": "r/0"}

    def boom():
        raise RuntimeError("view failed")

    bad = json.loads(open(tobs.export_replica(
        "r2", boom, directory=str(tmp_path))).read())
    assert "view failed" in bad["view_error"]


def test_metrics_http_under_concurrency(modes):
    """The endpoint on 127.0.0.1 port 0 answers concurrent scrapes while
    an engine serves: /metrics is the port registry's Prometheus text,
    /metrics.json its snapshot with the server's view under "extra", any
    other path 404."""
    import urllib.error
    import urllib.request

    model = GPTForCausalLM(gpt_tiny(), device="cpu", seed=3)
    server = teng.LLMServer(model, teng.LLMEngineConfig(
        num_slots=2, max_model_len=64))
    rng = np.random.default_rng(1)
    scrapes, errors = [], []

    def scraper(url):
        try:
            for _ in range(5):
                with urllib.request.urlopen(url, timeout=30) as r:
                    scrapes.append(r.read().decode())
        except Exception as e:
            errors.append(e)

    handle = None
    try:
        with server:
            handle = server.start_metrics_http()
            assert handle.host == "127.0.0.1" and handle.port > 0
            futs = [server.submit(rng.integers(0, 2048, (int(n),)),
                                  max_new_tokens=3)
                    for n in rng.integers(4, 20, 6)]
            threads = [threading.Thread(target=scraper, args=(handle.url,))
                       for _ in range(3)]
            for t in threads:
                t.start()
            outs = [f.result(timeout=120) for f in futs]
            for t in threads:
                t.join(timeout=60)
            with urllib.request.urlopen(handle.url + ".json",
                                        timeout=30) as r:
                j = json.loads(r.read())
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(
                    handle.url.replace("/metrics", "/nope"), timeout=30)
    finally:
        if handle is not None:
            handle.stop()
    assert not errors, errors
    assert len(outs) == 6 and len(scrapes) == 15
    assert all("pt_llm_requests_total" in s for s in scrapes)
    assert j["extra"]["num_slots"] == 2 and j["extra"]["finished"] >= 6
    assert "pt_llm_requests_total" in j["metrics"]
    assert server._http is None


def test_journal_ring_file_and_flight_mirror(tmp_path, monkeypatch,
                                             modes):
    """`resilience.record` appends to the in-memory ring and to
    anomalies.rank<r>.jsonl, counts `pt_journal_events_total{kind}` and
    mirrors the event into the flight recorder; the retry policy, the
    guards and the preemption handler construct and behave."""
    from paddle_tpu_torch.distributed import resilience as tres

    monkeypatch.setenv("PT_ANOMALY_DIR", str(tmp_path))
    tres.reset()
    try:
        c0 = tres._JOURNAL_EVENTS.labels(kind="probe").value
        e = tres.record("probe", x=1)
        assert tres.events("probe")[-1] == e and e["x"] == 1
        assert tres._JOURNAL_EVENTS.labels(kind="probe").value == c0 + 1
        line = (tmp_path / "anomalies.rank0.jsonl").read_text()
        assert json.loads(line.strip().splitlines()[-1])["kind"] == "probe"
        assert any(ev.get("entry", {}).get("kind") == "probe"
                   for ev in tfr.recorder().events("journal"))
        assert tres.recent_failures() == 0
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) == 1:
                raise OSError("transient")
            return "ok"

        pol = tres.RetryPolicy(max_attempts=2, base_s=0.0, name="probe")
        assert pol.run(flaky) == "ok" and tres.recent_failures() == 1
        assert not tres.StepGuard().check(torch.tensor(float("nan")))
        with pytest.raises(tres.DivergenceRollback):
            tres.DivergenceSentinel().check(float("inf"), step=0)
        for make in (tres.PreemptionHandler,
                     tres.install_preemption_handler):
            h = make()
            try:
                assert not h.triggered() and h.drain(step=1)
            finally:
                h.restore()
        kinds = [json.loads(x)["kind"] for x in (
            tmp_path / "anomalies.rank0.jsonl").read_text().splitlines()]
        assert kinds == ["probe", "retry", "nan_step", "rollback",
                         "preempt_drain", "preempt_drain"]
    finally:
        tres.reset()
