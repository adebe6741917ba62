"""Fleet router — radix-affinity routing, SLO autoscale, failover
(counterpart of paddle_tpu/inference/fleet_serving/router.py, host
logic copied).

N replica engines behind one submit surface. Three policies, all on the
host:

* **Radix-affinity routing.** The prompt's leading blocks are
  fingerprinted at `hash_block_tokens` granularity — the same
  content-at-position identity the per-engine `RadixPrefixCache` tries
  key on — and the request routes to the replica whose (router-side)
  prefix view holds the longest match, so a fleet sharing system prompts
  concentrates each prefix's KV on one replica instead of re-prefilling
  it everywhere. No match falls back to the least-loaded replica by the
  per-replica queue-depth / occupancy signals.

* **Prefill/decode disaggregation.** With prefill-role replicas
  attached, prompts at/above `prefill_min_tokens` prefill on a prefill
  replica and their finished KV pages move to the affinity-chosen
  decode replica (`kv_transfer`'s byte discipline), which admits the
  request at its frontier: long-prompt admission stops stealing the
  decode replicas' windows.

* **SLO autoscale + failover.** A monitor thread watches heartbeats and
  queue depth: sustained pressure above `queue_high` grows the fleet
  through the replica factory (up to `max_replicas`), an idle fleet
  shrinks gracefully, and a dead replica (chaos kill, wedge, crash) has
  its in-flight requests requeued — prompts replay through the prefix /
  KV machinery on a surviving replica, and greedy decode makes the
  replayed outputs token-identical to the unkilled run.

Failover guarantee: at-least-once execution with deterministic outputs —
a request may run twice (the killed replica's partial work is
discarded), never zero times, and the client-visible tokens are the same
either way. Requests are not persisted: losing the router process loses
its queue.

Metrics: pt_router_requests / pt_router_affinity_hits /
pt_router_replica_live / pt_router_requeues / pt_router_ttft_seconds
(+ the kv_transfer stream and the kv_tier migration counters).
`start_metrics_http` serves the whole in-process fleet in one scrape.
"""
import itertools
import threading
import time

import numpy as np

from ...observability import flight_recorder as _flight
from ...observability import metrics as _obs
from ...observability import reqtrace as _reqtrace
from .overload import (BrownoutController, CircuitBreaker, OverloadPolicy,
                       RequestCancelled, RequestShed, TTFTEstimator,
                       note_cancelled, note_hedge, note_shed)
from .replica import LocalReplica, ReplicaRegistry
from .scheduler import Priority

__all__ = ["AutoscalePolicy", "FleetRouter"]

_ROUTER_REQS = _obs.counter(
    "pt_router_requests",
    "requests routed by the fleet router (process-global)")
_AFFINITY_HITS = _obs.counter(
    "pt_router_affinity_hits",
    "routed requests whose chosen replica held a non-empty radix "
    "prefix match (the fleet-wide cache-locality rate)")
_REQUEUES = _obs.counter(
    "pt_router_requeues",
    "in-flight requests requeued off a dead replica (failover — "
    "greedy outputs stay token-identical under replay)")
_MONITOR_ERRORS = _obs.counter(
    "pt_router_monitor_errors",
    "exceptions swallowed by the router monitor's failover/autoscale "
    "ticks (supervision survives a bad tick, but a persistently "
    "failing one — e.g. a factory that cannot build replicas — must "
    "be visible, not a silent poll-rate retry loop)")
_SPILL_SCALEUPS = _obs.counter(
    "pt_router_spill_scale_ups",
    "scale-ups triggered by sustained fleet KV spill pressure rather "
    "than queue depth (the memory-bound growth signal: queues look "
    "healthy while the tier sheds pages, so TTFT regresses via cold "
    "recompute instead of visible backlog)")
_ROUTER_TTFT = _obs.histogram(
    "pt_router_ttft_seconds",
    "client-observed TTFT at the ROUTER ingress (submit -> the serving "
    "replica's first-token stamp) — the fleet-wide latency the "
    "per-engine pt_llm_ttft_seconds cannot see across a hand-off")


class AutoscalePolicy:
    """Autoscale/monitor knobs (docs/SERVING.md has the tuning table).

    min_replicas / max_replicas  fleet size bounds
    queue_high       mean waiting-per-replica that triggers scale-UP
                     (sustained: two consecutive monitor ticks)
    spill_high       fleet KV spill_pressure (fraction of spill
                     attempts the host-RAM/disk tier rejected or aged
                     out — kv_tier block in metrics()) at/above which
                     the fleet grows even with healthy queues; memory-
                     bound traffic sheds pages long before it queues.
                     Shares queue_high's two-tick hysteresis; an
                     over-pressure fleet never retires replicas
    queue_low        fleet-wide waiting total at/below which an IDLE
                     replica (no queue, no in-flight) may retire
    cooldown_s       minimum seconds between scaling actions
    heartbeat_timeout_s  staleness after which a replica counts dead
    poll_s           monitor loop period
    """

    def __init__(self, min_replicas=1, max_replicas=4, queue_high=8,
                 queue_low=0, cooldown_s=1.0, heartbeat_timeout_s=2.0,
                 poll_s=0.02, spill_high=0.5):
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        self.spill_high = float(spill_high)
        self.cooldown_s = float(cooldown_s)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.poll_s = float(poll_s)
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas ({self.min_replicas}) <= "
                f"max_replicas ({self.max_replicas})")


class _RoutedRequest:
    _ids = itertools.count()

    def __init__(self, prompt, kwargs, future, trace=None):
        self.rid = next(_RoutedRequest._ids)
        self.prompt = prompt
        self.kwargs = kwargs       # submit kwargs (eos, sampling, SLA)
        self.future = future       # client-facing
        # fleet-wide identity: every engine request, span, and KV
        # payload this request touches — on ANY replica — carries this
        # trace (observability.reqtrace). Requeue/replay attempts share
        # it; first-wins stamps keep the first attempt's timeline.
        self.trace = trace if trace is not None else _reqtrace.new_trace()
        self.trace.stamp("queued")
        self.replica = None        # name currently serving it
        self.internal = None       # the replica-side Future
        self.stage = None          # "prefill" | "decode"
        self.payload = None        # streamed KV (between stages)
        self.no_disagg = False     # prefill fallback taken
        self.requeues = 0
        self.affinity_hit = False
        self.resolved = False      # exactly-one-outcome gate (lock-held)
        self.t_submit = time.perf_counter()
        # overload control plane (fleet_serving.overload)
        self.deadline_t = None     # absolute perf_counter hard deadline
        self.hedges = 0            # hedged re-dispatches taken
        self._prefill_t0 = None    # hand-off latency (breaker window)


class FleetRouter:
    """N replicas behind one `submit` (module docstring).

        router = FleetRouter(factory=make_replica, policy=...)
        with router:
            fut = router.submit(prompt_ids, max_new_tokens=64)
            tokens = fut.result()

    `factory(name) -> LocalReplica` builds members (give each its OWN
    model copy — `replica.fork_model`); pre-built replicas can be
    passed instead/in addition via `replicas=[...]`. Prefill-role
    replicas (`prefill_replicas` or factory-built with
    `prefill_factory`) enable the disaggregated hand-off for prompts
    >= `prefill_min_tokens`."""

    def __init__(self, replicas=None, factory=None, policy=None,
                 hash_block_tokens=16, max_affinity_blocks=8,
                 prefill_replicas=None, prefill_min_tokens=None,
                 registry=None, overload=None, migrate_hot_hits=None,
                 migrate_interval_s=5.0, migrate_budget=2):
        self.policy = policy or AutoscalePolicy()
        # overload control plane (fleet_serving.overload; docs/SERVING
        # "Overload and degradation") — defaults are inert where
        # behaviour would change: brownout/hedging opt-in, generous
        # parking bound, failure-count-only breaker
        self.overload = overload or OverloadPolicy()
        self.registry = registry if registry is not None else \
            ReplicaRegistry(timeout_s=self.policy.heartbeat_timeout_s)
        self._factory = factory
        self.hash_block_tokens = int(hash_block_tokens)
        self.max_affinity_blocks = int(max_affinity_blocks)
        self.prefill_min_tokens = (None if prefill_min_tokens is None
                                   else int(prefill_min_tokens))
        # hot-prefix page migration (docs/SERVING.md "KV memory
        # hierarchy"): when a prefix's affinity holder is busier than
        # a peer, PULL its cached pages to the peer over the byte-
        # exact KV wire instead of routing around the miss. Off by
        # default (migrate_hot_hits=None); `migrate_hot_hits` routed
        # hits on one leading block within `migrate_interval_s` make
        # the prefix hot, and at most `migrate_budget` pulls run per
        # interval (a migration costs a D2H gather on the donor).
        self.migrate_hot_hits = (None if migrate_hot_hits is None
                                 else int(migrate_hot_hits))
        self.migrate_interval_s = float(migrate_interval_s)
        self.migrate_budget = int(migrate_budget)
        self._hot = {}             # first-block key -> hits this window
        self._hot_t0 = time.monotonic()
        self._migrations_left = self.migrate_budget
        self._lock = threading.Lock()
        self._replicas = {}        # name -> LocalReplica (decode/serve)
        self._prefill = {}         # name -> LocalReplica (prefill role)
        self._expelled = {}        # name -> replica removed by failover
        self._affinity = {}        # name -> {prefix-key: last-use clock}
        self._clock = itertools.count()
        self._inflight = {}        # rid -> _RoutedRequest
        # per-ROUTER TTFT distribution (unregistered Histogram: the
        # registry's pt_router_ttft_seconds is process-global — two
        # routers in one process must not blur each other's view)
        self._ttft_hist = _obs.Histogram("router_ttft_local")
        self._monitor = None
        self._running = False
        self._http = None
        self._last_scale = 0.0
        self._pressure_ticks = 0
        self.stats = {"requests": 0, "affinity_hits": 0, "requeues": 0,
                      "scale_ups": 0, "scale_downs": 0,
                      "spill_scale_ups": 0,
                      "disagg_handoffs": 0, "replicas_lost": 0,
                      "shed": 0, "cancelled": 0, "hedges": 0,
                      "brownout_level": 0, "migrations": 0,
                      "migration_failures": 0}
        pol = self.overload
        self._estimator = TTFTEstimator()
        self._breaker = CircuitBreaker(
            window=pol.breaker_window,
            failure_rate=pol.breaker_failure_rate,
            latency_s=pol.breaker_latency_s,
            min_events=pol.breaker_min_events,
            reset_s=pol.breaker_reset_s)
        self._brownout_ctl = BrownoutController(
            pol, apply_fn=self._apply_brownout)
        for r in (replicas or ()):
            self._adopt(r)
        for r in (prefill_replicas or ()):
            self._adopt(r)

    def _adopt(self, replica):
        with self._lock:
            if replica.role == "prefill":
                self._prefill[replica.name] = replica
            else:
                self._replicas[replica.name] = replica
                self._affinity.setdefault(replica.name, {})
        if self._brownout_ctl.level:
            # a member joining mid-brownout (scale-up, recovery) must
            # degrade like the rest of the fleet
            try:
                replica.engine.apply_brownout(self._brownout_ctl.caps())
            except Exception:
                # an engine without brownout support degrades later —
                # but the miss must be visible, not silent
                _MONITOR_ERRORS.inc()
        if replica._registry is not self.registry:
            # one membership view: the router's failover watches ITS
            # registry, so members must beat into it
            replica._registry = self.registry
            self.registry.register(replica)

    # ---- lifecycle ----

    def start(self):
        if self._running:
            return self
        while (len(self._replicas) < self.policy.min_replicas
               and self._factory is not None):
            self._scale_up()
        if not self._replicas:
            raise RuntimeError(
                "FleetRouter needs at least one serve-role replica "
                "(pass replicas=[...] or a factory)")
        self._running = True
        # dump-time state: every postmortem carries this router's full
        # fleet view (unique key — tests run several routers)
        self._fr_key = f"router:{id(self):x}"
        _flight.add_state_provider(self._fr_key, self.metrics)
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         name="fleet-router",
                                         daemon=True)
        self._monitor.start()
        return self

    def stop(self):
        self._running = False
        _flight.remove_state_provider(getattr(self, "_fr_key", ""))
        if self._monitor is not None:
            self._monitor.join(timeout=30)
            self._monitor = None
        if self._http is not None:
            self._http.stop()
            self._http = None
        for r in (list(self._replicas.values())
                  + list(self._prefill.values())
                  + [rep for rep, _ in list(self._expelled.values())]):
            # expelled members included: a wedged-then-recovered-too-
            # late replica still owns a live serve thread
            r.stop()
        # anything still unresolved after the graceful drain is lost
        for rr in self._drain_inflight():
            if not rr.future.done():
                rr.future.set_exception(
                    RuntimeError("router stopped with request in flight"))

    def _drain_inflight(self):
        with self._lock:
            out = list(self._inflight.values())
            self._inflight.clear()
        return out

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ---- client surface ----

    def submit(self, prompt, max_new_tokens=32, eos_token_id=None,
               **kw):
        """Route one prompt; returns the client Future (tokens). The
        kwargs surface is `LLMServer.submit`'s, plus the overload
        knobs: `deadline_s` is a HARD deadline — a request whose
        deadline is provably unmeetable sheds at submit with a typed
        `RequestShed` (retry_after_s hint attached), one that expires
        mid-flight cancels with `RequestCancelled`. The returned
        future carries `pt_rid`, the handle `cancel(pt_rid)` takes."""
        from concurrent.futures import Future

        if not self._running:
            raise RuntimeError("router not started (use `with router:`)")
        # loud ingress hardening (same pattern as the engine's
        # _check_import): an unknown kwarg or a malformed structured-
        # decoding constraint raises HERE, at submit(), with the
        # offending name — not as a serve-loop error on whichever
        # replica the request lands, where it would abort co-resident
        # requests. Grammar COMPILATION still happens replica-side
        # (it needs the engine's token_strs); this gate is structural.
        from ..llm_engine import SUBMIT_KWARGS
        from ..structured import validate_constraints

        unknown = set(kw) - SUBMIT_KWARGS
        if unknown:
            raise TypeError(
                f"submit() got unknown kwarg(s) {sorted(unknown)} — "
                f"the surface is {sorted(SUBMIT_KWARGS)}")
        validate_constraints(grammar=kw.get("grammar"),
                             json_schema=kw.get("json_schema"),
                             spec_mode=kw.get("spec_mode"))
        prompt = np.asarray(prompt).reshape(-1)
        # a caller-minted trace (a gateway in front of this router)
        # must not collide with the per-replica submit's own trace kwarg
        trace = kw.pop("trace", None)
        deadline_s = kw.pop("deadline_s", None)
        rr = _RoutedRequest(
            prompt, dict(max_new_tokens=int(max_new_tokens),
                         eos_token_id=eos_token_id, **kw), Future(),
            trace=trace)
        rr.future.pt_rid = rr.rid     # the cancel() handle
        if deadline_s is not None:
            rr.deadline_t = rr.t_submit + float(deadline_s)
        with self._lock:
            self._inflight[rr.rid] = rr
            self.stats["requests"] += 1
        _ROUTER_REQS.inc()
        self._estimator.note_prompt(len(prompt))
        self._admission_control(rr, deadline_s)
        if not rr.future.done():
            self._dispatch(rr)
        return rr.future

    def generate(self, prompt, max_new_tokens=32, eos_token_id=None):
        return self.submit(prompt, max_new_tokens, eos_token_id).result()

    def cancel(self, request_id, reason="client"):
        """Cancel one in-flight request (`fut.pt_rid` is the handle).
        The abort propagates across every tier the request currently
        touches — router bookkeeping, the replica engine serving it
        (slot, pool pages, trie pins), and any KV payload parked
        between the prefill and decode stages — and the client future
        resolves with `RequestCancelled`. Returns False when the id is
        unknown or already resolved (result delivery won the race)."""
        with self._lock:
            rr = self._inflight.get(int(request_id))
            if rr is None or rr.resolved:
                return False
            rr.resolved = True       # exactly-one-outcome gate
            self._inflight.pop(rr.rid, None)
            self.stats["cancelled"] += 1
            rep = (self._replicas.get(rr.replica)
                   or self._prefill.get(rr.replica))
        note_cancelled(reason)
        rr.trace.stamp("cancelled")
        _flight.record_event("request_cancelled", rid=rr.rid,
                             trace_id=rr.trace.trace_id, reason=reason,
                             stage=rr.stage, replica=rr.replica)
        rr.payload = None            # KV parked between stages: dropped
        internal = rr.internal
        if internal is not None:
            req = getattr(internal, "pt_request", None)
            if req is not None and rep is not None:
                # already ingested by the replica engine: evict there
                # (counted here — the engine must not double-count)
                rep.abort(req.rid, reason=reason, counted=True)
            else:
                # still in the server queue: the ingest loop skips
                # cancelled futures without touching the engine
                internal.cancel()
        if not rr.future.done():
            rr.future.set_exception(RequestCancelled(
                reason=reason, trace_id=rr.trace.trace_id))
        return True

    # ---- admission control (fleet_serving.overload) ----

    def _shed_key(self, rr):
        """Shed order under pressure: LOWEST priority class first, then
        LATEST deadline (no deadline = infinitely patient = first to
        go), then newest. max() of this key picks the victim."""
        pri = rr.kwargs.get("priority")
        pri = int(Priority.STANDARD if pri is None else pri)
        dl = (float("inf") if rr.deadline_t is None
              else rr.deadline_t)
        return (pri, dl, rr.rid)

    def _shed(self, rr, reason, retry_after_s=None):
        """Typed admission refusal: pop from inflight, count, flight-
        record, resolve the client future with RequestShed. Respects
        the exactly-one-outcome gate; returns False when rr already
        resolved."""
        with self._lock:
            if rr.resolved:
                return False
            rr.resolved = True
            self._inflight.pop(rr.rid, None)
            self.stats["shed"] += 1
        note_shed(reason)
        _flight.record_event("request_shed", rid=rr.rid,
                             trace_id=rr.trace.trace_id, reason=reason,
                             retry_after_s=retry_after_s)
        if not rr.future.done():
            rr.future.set_exception(RequestShed(
                reason, retry_after_s=retry_after_s,
                trace_id=rr.trace.trace_id))
        return True

    def _queued_tokens(self):
        """Work ahead of a new arrival, in tokens (queue depths ×
        the EMA prompt length) — the TTFT lower bound's numerator."""
        depth = sum(r.queue_depth() for r in self._alive_replicas())
        with self._lock:
            depth += sum(rr.stage == "parked"
                         for rr in self._inflight.values())
        return depth * self._estimator.avg_prompt_tokens()

    def _admission_control(self, rr, deadline_s):
        """Reject-early checks at submit (docs/SERVING.md "Overload
        and degradation"): expired deadline, provably-unmeetable
        deadline (optimistic TTFT lower bound from live telemetry vs
        the deadline), brownout best-effort-class shed, and the
        max_inflight capacity bound (worst parked victim — or the
        newcomer — sheds)."""
        pol = self.overload
        if deadline_s is not None:
            ds = float(deadline_s)
            if ds <= 0.0:
                self._shed(rr, "deadline")
                return
            lb = self._estimator.lower_bound_ttft(
                self._queued_tokens() + len(rr.prompt))
            if lb > ds:
                # provable: even at the best service rate ever
                # observed the first token lands after the deadline
                self._shed(rr, "deadline_unmeetable",
                           retry_after_s=round(lb - ds, 3))
                return
        sp = self._brownout_ctl.shed_priority()
        if sp is not None:
            pri = rr.kwargs.get("priority")
            pri = int(Priority.STANDARD if pri is None else pri)
            if pri >= int(sp):
                self._shed(rr, "brownout", retry_after_s=max(
                    0.05, round(self._estimator.lower_bound_ttft(
                        self._queued_tokens()), 3)))
                return
        if pol.max_inflight is not None:
            with self._lock:
                over = len(self._inflight) > pol.max_inflight
                cands = ([x for x in self._inflight.values()
                          if x.stage == "parked"] + [rr]) if over else ()
            if over:
                victim = max(cands, key=self._shed_key)
                self._shed(victim, "capacity", retry_after_s=max(
                    0.05, round(self._estimator.lower_bound_ttft(
                        self._queued_tokens()), 3)))

    # ---- routing ----

    def _block_keys(self, tokens):
        """Leading-block fingerprints: key i covers tokens[:(i+1)*bt] —
        content AND position, the RadixPrefixCache node identity, so
        router affinity and the engine trie agree on what 'the same
        prefix' means."""
        bt = self.hash_block_tokens
        n = min(len(tokens) // bt, self.max_affinity_blocks)
        return [np.asarray(tokens[:(i + 1) * bt], np.int32).tobytes()
                for i in range(n)]

    def _alive_replicas(self, exclude=()):
        with self._lock:
            reps = list(self._replicas.values())
        return [r for r in reps
                if r.name not in exclude and r.alive]

    def _pick(self, tokens, exclude=()):
        """(replica, matched_blocks): longest router-side prefix match,
        least-loaded fallback. Registers the prompt's blocks on the
        winner so the NEXT same-prefix request lands there too."""
        alive = self._alive_replicas(exclude)
        if not alive:
            return None, 0
        keys = self._block_keys(tokens)
        best, best_len = None, 0
        for r in alive:
            store = self._affinity.get(r.name, {})
            ln = 0
            for k in keys:
                if k not in store:
                    break
                ln += 1
            if ln > best_len:
                best, best_len = r, ln
        if best is None:
            best = min(alive, key=lambda r: r.load())
        if keys:
            with self._lock:
                store = self._affinity.setdefault(best.name, {})
                for k in keys:
                    store[k] = next(self._clock)
                cap = 4096 * self.max_affinity_blocks
                if len(store) > cap:
                    # LRU cap: affinity is a ROUTING HINT, not state —
                    # dropping old keys only costs a fallback route.
                    # Trim to HALF the cap (not a flat floor): the hit
                    # rate degrades smoothly instead of collapsing to
                    # ~nothing on every trim
                    keep = sorted(store.items(), key=lambda kv: kv[1],
                                  reverse=True)[:cap // 2]
                    self._affinity[best.name] = dict(keep)
        return best, best_len

    def _pick_prefill(self, exclude=()):
        with self._lock:
            reps = list(self._prefill.values())
        alive = [r for r in reps if r.name not in exclude and r.alive]
        if not alive:
            return None
        return min(alive, key=lambda r: r.load())

    def _deadlined(self, kwargs, rr):
        """Per-dispatch submit kwargs: the REMAINING deadline rides to
        the replica engine (which expires it mid-flight) — remaining,
        not absolute, so a requeued attempt keeps the original
        contract. kwargs is copied; rr.kwargs stays pristine for
        re-dispatch."""
        kw = dict(kwargs)
        if rr.deadline_t is not None:
            kw["deadline_s"] = rr.deadline_t - time.perf_counter()
        return kw

    def _dispatch(self, rr, exclude=()):
        """Place `rr` on a replica (possibly via the prefill stage).
        Called at submit, at stage hand-off, at failover requeue, and
        at hedged re-dispatch — a superseded internal future's outcome
        is suppressed by the stale-attempt checks."""
        if rr.future.done():
            return
        disagg = (self.prefill_min_tokens is not None
                  and not rr.no_disagg and rr.payload is None
                  and len(rr.prompt) >= self.prefill_min_tokens)
        if disagg:
            pre = self._pick_prefill(exclude)
            if pre is None:
                rr.no_disagg = True  # no live prefill: serve whole
            elif self._breaker.allow() and self._dispatch_prefill(rr, pre):
                # breaker open ≠ no_disagg: the tier is SICK, not
                # absent — a later (requeued) dispatch may retry it
                # once the breaker half-opens
                return
        rep, matched = self._pick(rr.prompt, exclude)
        if rep is None:
            # no live replica AT ALL: park it — the monitor requeues
            # once the factory (or a recovering heartbeat) restores
            # one. The parking queue is BOUNDED: past max_parked the
            # worst-placed request (shed order) gets a typed shed
            # instead of unbounded growth.
            with self._lock:
                parked = [x for x in self._inflight.values()
                          if x.stage == "parked" and x is not rr]
            if len(parked) >= self.overload.max_parked:
                victim = max(parked + [rr], key=self._shed_key)
                self._shed(victim, "no_capacity")
                if victim is rr:
                    return
            rr.stage, rr.replica, rr.internal = "parked", None, None
            return
        if matched and rr.requeues == 0 and rr.payload is None:
            rr.affinity_hit = True
            with self._lock:
                self.stats["affinity_hits"] += 1
            _AFFINITY_HITS.inc()
            target = self._migrate_check(rr, rep)
            if target is not None and self._start_migration(
                    rr, rep, target):
                return
        rr.stage = "decode"
        rr.replica = rep.name
        rr.trace.stamp("routed")
        if rr.payload is not None:
            with self._lock:
                self.stats["disagg_handoffs"] += 1
            payload, rr.payload = rr.payload, None  # consumed
            rr.internal = rep.submit_imported(
                payload, trace=rr.trace, **self._deadlined(rr.kwargs, rr))
        else:
            rr.internal = rep.submit(
                rr.prompt, trace=rr.trace,
                **self._deadlined(rr.kwargs, rr))
        rr.internal.add_done_callback(
            lambda f, rr=rr: self._on_decode_done(rr, f))

    def _dispatch_prefill(self, rr, pre):
        """Bind rr to the prefill tier; False when the submit itself
        fails (a stopping replica) — counted against the breaker, and
        the caller falls through to whole-request serving."""
        rr.stage, rr.replica = "prefill", pre.name
        rr.trace.stamp("routed")
        rr._prefill_t0 = time.monotonic()
        try:
            rr.internal = pre.submit_prefill(
                rr.prompt, trace=rr.trace,
                **self._deadlined(
                    {k: rr.kwargs[k] for k in
                     ("tenant", "priority", "ttft_slo_s")
                     if k in rr.kwargs}, rr))
        except Exception:
            self._breaker.record_failure()
            rr.stage, rr.replica = None, None
            return False
        rr.internal.add_done_callback(
            lambda f, rr=rr: self._on_prefill_done(rr, f))
        return True

    def _on_prefill_done(self, rr, fut):
        if rr.future.done() or fut is not rr.internal:
            # stale attempt: the request was already requeued onto
            # another replica — the live attempt owns the hand-off
            return
        err = fut.exception()
        if isinstance(err, (RequestCancelled, RequestShed)):
            # the ENGINE cancelled/shed this very request (deadline
            # expiry, brownout class): that is the request's typed
            # outcome, not tier sickness — propagate, don't fall back
            # and don't count against the breaker
            with self._lock:
                if rr.resolved:
                    return
                rr.resolved = True
                self._inflight.pop(rr.rid, None)
            if not rr.future.done():
                rr.future.set_exception(err)
            return
        if err is not None:
            # prefill failed (bad request / replica abort): fall back
            # to serving the whole request on a decode replica — only a
            # request the DECODE side also rejects errors the client
            self._breaker.record_failure()
            rr.no_disagg = True
            self._dispatch(rr)
            return
        self._breaker.record_success(
            0.0 if rr._prefill_t0 is None
            else time.monotonic() - rr._prefill_t0)
        rr.payload = fut.result()
        rr.trace.stamp("kv_transfer")   # the in-process hand-off moment
        self._dispatch(rr)

    def _on_decode_done(self, rr, fut):
        if rr.future.done():
            return
        err = fut.exception()
        if err is not None and fut is not rr.internal:
            # a SUPERSEDED attempt failing late (the replica it ran
            # on died/aborted after the requeue) must not poison the
            # client while the live retry is still running — that
            # would be the very death the failover guarantee hides.
            # (A stale SUCCESS is kept: greedy outputs are
            # deterministic, so first-wins is correct.)
            return
        # exactly-one-outcome gate: a stale and a live attempt can
        # complete near-simultaneously on two replica threads — only
        # the winner may resolve, attach pt_request, and record TTFT
        # (the loser would otherwise clobber pt_request and append a
        # second, wedge-inflated TTFT sample)
        with self._lock:
            if rr.resolved:
                return
            rr.resolved = True
        if err is not None:
            if not rr.future.done():
                rr.future.set_exception(err)
        else:
            req = getattr(fut, "pt_request", None)
            # mirror the LLMServer.submit contract on the CLIENT
            # future (set BEFORE the result so a completed future
            # always carries it): the serving replica's _Request is
            # where per-request TTFT stamps live
            rr.future.pt_request = req
            if not rr.future.done():
                rr.future.set_result(fut.result())
            if req is not None and req.t_first_token is not None:
                ttft = req.t_first_token - rr.t_submit
                self._ttft_hist.observe(ttft)
                _ROUTER_TTFT.observe(ttft)
        with self._lock:
            self._inflight.pop(rr.rid, None)

    # ---- hot-prefix page migration (docs/SERVING.md) ----

    def _migrate_check(self, rr, holder):
        """Pull-vs-route decision for an affinity-hit request: returns
        the replica to pull the prefix's pages TO, or None to route to
        the holder as usual. A prefix is hot once its leading block
        takes `migrate_hot_hits` routed hits inside the current
        `migrate_interval_s` window; the pull fires only while the
        window's `migrate_budget` lasts and only toward a STRICTLY
        less-loaded alive peer (the point is relieving the holder, not
        shuffling pages between equally-busy members)."""
        if self.migrate_hot_hits is None or rr.requeues:
            return None
        keys = self._block_keys(rr.prompt)
        if not keys:
            return None
        now = time.monotonic()
        with self._lock:
            if now - self._hot_t0 >= self.migrate_interval_s:
                self._hot_t0 = now
                self._hot.clear()
                self._migrations_left = self.migrate_budget
            hits = self._hot.get(keys[0], 0) + 1
            self._hot[keys[0]] = hits
            if hits < self.migrate_hot_hits or not self._migrations_left:
                return None
        peers = [r for r in self._alive_replicas()
                 if r.name != holder.name and r.load() < holder.load()]
        if not peers:
            return None
        with self._lock:
            self._migrations_left -= 1
            self._hot[keys[0]] = 0    # re-arm: next pull needs fresh heat
        return min(peers, key=lambda r: r.load())

    def _start_migration(self, rr, src, target):
        """Kick the donor's engine-thread prefix cut; rr parks in stage
        'migrate' (the failover orphan sweep covers it) until the
        payload lands. False when the donor refuses the export (a
        stopping replica) — the caller routes normally."""
        rr.stage, rr.replica = "migrate", src.name
        try:
            fut = src.export_prefix(rr.prompt)
        except Exception:
            rr.stage, rr.replica = None, None
            return False
        rr.internal = fut
        fut.add_done_callback(
            lambda f, rr=rr, t=target: self._on_migrate_export(rr, t, f))
        return True

    def _on_migrate_export(self, rr, target, fut):
        if rr.future.done() or fut is not rr.internal:
            return     # stale attempt: failover already requeued rr
        from .kv_tier import _MIGRATIONS
        from .kv_transfer import pack_kv_payload, unpack_kv_payload

        payload = None if fut.exception() is not None else fut.result()
        if payload is None or not target.alive:
            # donor trie went cold (evicted under us) or the export
            # died or the target died meanwhile: route normally, once
            with self._lock:
                self.stats["migration_failures"] += 1
            rr.internal = None
            self._dispatch(rr)
            return
        # the byte-exact wire discipline: the payload crosses pack ->
        # unpack exactly as a cross-process pull would, so the imported
        # bytes are the donor's stored bytes (no re-encode: int4 / int8
        # codes and scale planes ride verbatim)
        payload = unpack_kv_payload(pack_kv_payload(payload))
        nb = payload.n_prefilled // self.hash_block_tokens
        with self._lock:
            self.stats["migrations"] += 1
            store = self._affinity.setdefault(target.name, {})
            for k in self._block_keys(rr.prompt)[:nb]:
                store[k] = next(self._clock)
        _MIGRATIONS.inc()
        _flight.record_event("kv_migration", rid=rr.rid,
                             trace_id=rr.trace.trace_id,
                             to=target.name, was_on=rr.replica,
                             pages=payload.num_pages)
        rr.stage, rr.replica = "decode", target.name
        rr.internal = target.submit_imported(
            payload, trace=rr.trace, **self._deadlined(rr.kwargs, rr))
        rr.internal.add_done_callback(
            lambda f, rr=rr: self._on_decode_done(rr, f))

    # ---- monitor: failover + autoscale ----

    def _monitor_loop(self):
        # the monitor must outlive any single bad tick (a failover
        # racing a graceful stop() retries next poll rather than
        # ending supervision) — but every swallowed error is COUNTED
        # and kept in the snapshot, and the ticks fail independently
        # (an autoscale error must not mask the failover scan)
        last_state = 0.0
        while self._running:
            time.sleep(self.policy.poll_s)
            try:
                self._failover_tick()
            except Exception as e:
                self._note_monitor_error(e)
            try:
                self._autoscale_tick()
            except Exception as e:
                self._note_monitor_error(e)
            try:
                self._overload_tick()
            except Exception as e:
                self._note_monitor_error(e)
            now = time.monotonic()
            if now - last_state >= 0.5:
                # throttled fleet-state capture into the flight ring:
                # a postmortem shows the minutes BEFORE the failure,
                # not just its instant
                last_state = now
                try:
                    with self._lock:
                        reps = list(self._replicas.values()) + list(
                            self._prefill.values())
                        inflight = len(self._inflight)
                    _flight.record_event(
                        "router_state", inflight=inflight,
                        requeues=self.stats["requeues"],
                        replicas={r.name: {"alive": r.alive,
                                           "queue": r.queue_depth()}
                                  for r in reps})
                except Exception as e:
                    self._note_monitor_error(e)

    def _note_monitor_error(self, exc):
        _MONITOR_ERRORS.inc()
        with self._lock:
            self.stats["monitor_errors"] = (
                self.stats.get("monitor_errors", 0) + 1)
            self.stats["last_monitor_error"] = repr(exc)

    def _failover_tick(self):
        # recovery scan FIRST: an expelled member that TICKED after
        # its expulsion was only transiently stale (a wedge that
        # cleared, a slow step) — re-register (fresh beat) and
        # re-adopt it, so a stall never permanently shrinks the fleet
        # (its requeued work may have run twice: at-least-once,
        # outputs deterministic). Progress evidence is `last_tick`,
        # NOT thread aliveness: a STILL-hung loop is `running` too,
        # and re-adopting it would flap expel→re-adopt every
        # heartbeat timeout, stranding fresh dispatches on a wedge.
        # A killed/dead member never ticks again and stays expelled
        # until stop().
        with self._lock:
            expelled = list(self._expelled.items())
        for name, (rep, t_expelled) in expelled:
            if rep.running and rep.last_tick > t_expelled:
                with self._lock:
                    self._expelled.pop(name, None)
                    self.stats["replicas_recovered"] = (
                        self.stats.get("replicas_recovered", 0) + 1)
                self.registry.register(rep)
                self._adopt(rep)
        with self._lock:
            serve = list(self._replicas.items())
            pre = list(self._prefill.items())
        for name, rep in serve + pre:
            # DEAD = not alive: loop stopped OR heartbeat stale. A
            # WEDGED loop (hang injector, stuck dispatch) keeps its
            # thread — gating on `running` too would strand its
            # in-flight work forever
            if rep.alive:
                continue
            self._handle_death(name, rep)
        # orphan sweep: a dispatch that raced a death can bind a
        # request to a member _handle_death already removed (its
        # victims snapshot predates the bind) — requeue anything
        # pointing at a name that is no longer registered
        with self._lock:
            members = set(self._replicas) | set(self._prefill)
            orphans = [rr for rr in self._inflight.values()
                       if rr.stage in ("prefill", "decode", "migrate")
                       and rr.replica is not None
                       and rr.replica not in members
                       and not rr.future.done()]
        orphan_info = [{"rid": rr.rid, "trace_id": rr.trace.trace_id,
                        "was_on": rr.replica} for rr in orphans]
        for rr in orphans:
            self._requeue(rr, exclude={rr.replica})
        if orphans:
            # a requeue with NO death this tick (the dispatch-vs-death
            # TOCTOU): still a failover event worth a postmortem
            _flight.dump("failover_requeue", requeued=orphan_info)
        self.registry._publish()

    def _requeue(self, rr, exclude):
        rr.requeues += 1
        rr.internal = None
        rr.payload = None        # streamed KV lived in the dead pool
        with self._lock:
            self.stats["requeues"] += 1
        _REQUEUES.inc()
        _flight.record_event("failover_requeue", rid=rr.rid,
                             trace_id=rr.trace.trace_id,
                             exclude=sorted(exclude),
                             attempt=rr.requeues)
        self._dispatch(rr, exclude=exclude)

    def _handle_death(self, name, rep):
        """Remove a dead member and requeue everything it was serving.
        The replay path IS the ordinary dispatch path: prompts re-route
        (minus the dead replica) through prefix-cache/KV machinery, and
        greedy decode reproduces the identical tokens."""
        with self._lock:
            self._replicas.pop(name, None)
            self._prefill.pop(name, None)
            self._affinity.pop(name, None)  # its cached KV died with it
            # recovery scan / stop() track it; the stamp is the bar a
            # future tick must clear to prove the wedge ended
            self._expelled[name] = (rep, time.monotonic())
            victims = [rr for rr in self._inflight.values()
                       if rr.replica == name and not rr.future.done()]
            self.stats["replicas_lost"] += 1
        self.registry.deregister(name)
        rep._drop_gauges()   # a dead member must not export frozen load
        for rr in victims:
            self._requeue(rr, exclude={name})
        # postmortem: the dead member, everything it was serving (with
        # trace ids — the merged timeline's keys), and the ring that
        # holds the last seconds of spans/phases/journal leading in
        _flight.dump(
            "replica_death", replica=name, role=rep.role,
            last_tick_age_s=round(time.monotonic() - rep.last_tick, 3),
            requeued=[{"rid": rr.rid, "trace_id": rr.trace.trace_id,
                       "stage": rr.stage, "requeues": rr.requeues}
                      for rr in victims],
            stats=dict(self.stats))

    def _autoscale_tick(self):
        pol = self.policy
        now = time.monotonic()
        alive = self._alive_replicas()
        # parked requests (a no-replica window) re-dispatch as soon as
        # capacity exists
        if alive:
            with self._lock:
                parked = [rr for rr in self._inflight.values()
                          if rr.stage == "parked"]
            for rr in parked:
                self._dispatch(rr)
        if self._factory is None:
            return
        if now - self._last_scale < pol.cooldown_s:
            return
        with self._lock:
            waiting = sum(rr.stage == "parked"
                          for rr in self._inflight.values())
        depth = sum(r.queue_depth() for r in alive) + waiting
        if len(alive) < pol.min_replicas:
            self._scale_up()
            return
        queue_hot = bool(alive) and depth / len(alive) >= pol.queue_high
        # memory-bound growth signal: the KV tier shedding pages is
        # pressure the queue never shows (lookups still succeed — they
        # just recompute cold prefixes, so TTFT regresses silently).
        # Only scraped when the queue is NOT already hot: one signal
        # firing is enough, and the scrape costs a metrics() call per
        # replica.
        spill_hot = False
        if not queue_hot and alive:
            sp = self._fleet_spill_pressure(alive)
            spill_hot = sp is not None and sp >= pol.spill_high
        if (queue_hot or spill_hot) and len(alive) < pol.max_replicas:
            # sustained pressure only: one hot tick must not double the
            # fleet. Queue and spill pressure SHARE the tick counter —
            # both are "the fleet is too small", and alternating
            # signals should not reset each other's evidence.
            with self._lock:
                self._pressure_ticks += 1
                fire = self._pressure_ticks >= 2
                if fire:
                    self._pressure_ticks = 0
            if fire:
                self._scale_up()
                if spill_hot and not queue_hot:
                    with self._lock:
                        self.stats["spill_scale_ups"] += 1
                    _SPILL_SCALEUPS.inc()
            return
        self._pressure_ticks = 0
        # an over-pressure tier also vetoes retirement: killing a
        # replica while the fleet sheds pages trades the idle slot for
        # MORE cold recompute
        if (depth <= pol.queue_low and len(alive) > pol.min_replicas
                and not spill_hot):
            idle = [r for r in alive if r.load() == (0, 0.0)
                    and not self._has_inflight(r.name)]
            if idle:
                self._scale_down(idle[-1])

    def _has_inflight(self, name):
        with self._lock:
            return any(rr.replica == name
                       for rr in self._inflight.values())

    @staticmethod
    def _tier_block(tiers):
        """Fold per-replica kv_tier snapshots into ONE fleet block
        with hit/spill-pressure rates. Shared by `metrics()` (the
        scrape view) and `_autoscale_tick` (the growth signal) so the
        number an operator reads is the number the autoscaler acts
        on. `tiers` yields kv_tier dicts (None/empty skipped)."""
        tier_totals, tier_n = {}, 0
        for t in tiers:
            if not t:
                continue
            tier_n += 1
            for k, v in t.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    tier_totals[k] = tier_totals.get(k, 0) + v
        if not tier_n:
            return None
        g = tier_totals.get
        lookups = g("ram_hits", 0) + g("disk_hits", 0) + g("misses", 0)
        attempts = (g("spills", 0) + g("spill_failed", 0)
                    + g("spill_rejected", 0))
        dropped = (g("spill_rejected", 0) + g("ram_dropped", 0)
                   + g("disk_dropped", 0))
        kv_tier = dict(tier_totals)
        kv_tier.update({
            "replicas_with_tier": tier_n,
            # spilled-prefix lookups served below the device pool / all
            "hit_rate": ((g("ram_hits", 0) + g("disk_hits", 0))
                         / lookups) if lookups else None,
            # fraction of spill attempts the tier had to reject or
            # age out — rising pressure means the fleet's cold
            # capacity is saturating (scale out, or grow the tier)
            "spill_pressure": (dropped / (attempts + dropped)
                               if attempts + dropped else None),
        })
        return kv_tier

    def _fleet_spill_pressure(self, alive):
        """Fleet-wide KV spill_pressure from the alive replicas'
        engine views, or None when no replica runs a tier (tierless
        fleets autoscale on queue depth alone). Per-replica scrape
        failures are skipped — a dying member must not stall the
        autoscale decision for the rest."""
        tiers = []
        for r in alive:
            try:
                tiers.append(r.engine.metrics().get("kv_tier"))
            except Exception:
                pass
        block = self._tier_block(tiers)
        return block["spill_pressure"] if block else None

    # ---- overload tick (fleet_serving.overload) ----

    def _apply_brownout(self, level, caps):
        """BrownoutController apply_fn: push the level's caps to every
        member engine (serve AND prefill tier — the prefill engines
        honour shed_priority/deadline the same way)."""
        with self._lock:
            reps = (list(self._replicas.values())
                    + list(self._prefill.values()))
            self.stats["brownout_level"] = level
        for r in reps:
            try:
                r.engine.apply_brownout(caps)
            except Exception as e:
                self._note_monitor_error(e)

    def _overload_tick(self):
        """One monitor pass of the overload control plane: feed the
        admission estimator (fleet service rate), feed the brownout
        controller (pressure = queue depth per alive replica), expire
        deadlines the engines cannot see (parked / between-stages
        requests — plus a grace-lagged sweep behind a wedged engine),
        and hedge requests stuck behind a replica that stopped ticking
        (BEFORE failover's heartbeat timeout would fire)."""
        pol = self.overload
        now_m = time.monotonic()
        alive = self._alive_replicas()
        with self._lock:
            pre_alive = [p for p in self._prefill.values() if p.alive]
        # service-rate sample: cumulative tokens_in across the fleet —
        # the estimator keeps the PEAK inter-tick rate and discards
        # negative deltas (a member died/re-warmed out of the sum)
        try:
            tokens = sum(int(r.engine.stats.get("tokens_in", 0))
                         for r in alive + pre_alive)
            self._estimator.note_progress(tokens, now_m)
        except Exception:
            # a malformed stats dict skips ONE rate sample — count it
            # (a persistently failing sample starves the estimator)
            _MONITOR_ERRORS.inc()
        # brownout pressure
        if alive:
            with self._lock:
                parked = sum(rr.stage == "parked"
                             for rr in self._inflight.values())
            depth = sum(r.queue_depth() for r in alive) + parked
            self._brownout_ctl.note_pressure(depth / len(alive), now_m)
        # deadline sweep: the engines expire their own requests, but a
        # PARKED request has no engine, and a request on a WEDGED
        # engine never reaches the expiry scan — sweep those here
        # (grace-lagged for dispatched stages so a healthy engine's
        # own cancel, with its fuller timeline, wins the race)
        now_p = time.perf_counter()
        with self._lock:
            expired = [rr for rr in self._inflight.values()
                       if rr.deadline_t is not None and not rr.resolved
                       and now_p > rr.deadline_t
                       + (0.0 if rr.stage == "parked" else 0.25)]
        for rr in expired:
            self.cancel(rr.rid, reason="deadline")
        # hedged re-dispatch
        if pol.hedge_after_s is None:
            return
        stale_s = (pol.hedge_stale_s if pol.hedge_stale_s is not None
                   else 0.25 * self.policy.heartbeat_timeout_s)
        with self._lock:
            cands = [rr for rr in self._inflight.values()
                     if rr.stage in ("prefill", "decode")
                     and not rr.resolved and rr.hedges == 0
                     and rr.internal is not None
                     and not rr.internal.done()
                     and now_p - rr.t_submit >= pol.hedge_after_s]
            reps = dict(self._replicas)
            reps.update(self._prefill)
        for rr in cands:
            rep = reps.get(rr.replica)
            if rep is None or not rep.running:
                continue    # dead member: failover owns the requeue
            if now_m - rep.last_tick < stale_s:
                continue    # still making progress: not wedged
            if not self._alive_replicas(exclude={rr.replica}):
                continue    # nowhere to hedge to
            rr.hedges += 1
            with self._lock:
                self.stats["hedges"] += 1
            note_hedge()
            _flight.record_event(
                "request_hedged", rid=rr.rid,
                trace_id=rr.trace.trace_id, was_on=rr.replica,
                tick_age_s=round(now_m - rep.last_tick, 3))
            rr.payload = None   # a stale stage hand-off is not reusable
            self._dispatch(rr, exclude={rr.replica})

    def _scale_up(self):
        name = f"replica{next(_scale_names)}"
        rep = self._factory(name)
        self._adopt(rep)
        with self._lock:
            self.stats["scale_ups"] += 1
        self._last_scale = time.monotonic()
        self.registry._publish()
        return rep

    def _scale_down(self, rep):
        with self._lock:
            self._replicas.pop(rep.name, None)
            self._affinity.pop(rep.name, None)
            self.stats["scale_downs"] += 1
        rep.stop()   # graceful: queue is empty by the idle check
        self._last_scale = time.monotonic()
        self.registry._publish()

    # ---- observability ----

    def num_replicas(self):
        with self._lock:
            return len(self._replicas)

    def ttft_quantile(self, q):
        """Router-ingress TTFT percentile (the histogram replaces the
        old hand-kept sample list — satellite: percentiles come from
        the metrics substrate, not per-caller np.percentile)."""
        if self._ttft_hist.count == 0:
            return None
        return self._ttft_hist.quantile(q)

    def metrics(self):
        """ONE fleet-wide snapshot (scrape-safe): router policy state,
        per-replica engine views keyed by replica name (the labels the
        per-process islands lacked), the fleet TTFT distribution, the
        process-wide TTFT phase decomposition, and the last requests'
        merged timelines. The Prometheus text of the port's registry
        carries the same per-replica identity via pt_replica_*{replica}
        series."""
        with self._lock:
            reqs = self.stats["requests"]
            hits = self.stats["affinity_hits"]
            snap = dict(self.stats)
            inflight = len(self._inflight)
            reps = list(self._replicas.values()) + list(
                self._prefill.values())
        replicas = {}
        recent = []
        for r in reps:
            info = {"role": r.role, "alive": r.alive,
                    "queue_depth": r.queue_depth(),
                    "mean_slot_occupancy": r.engine.mean_occupancy}
            try:
                eng = r.engine.metrics()
                recent += eng.pop("recent_requests", [])
                info["engine"] = eng
            except Exception as e:   # a dying member must not kill the
                info["engine_error"] = repr(e)   # whole fleet scrape
            replicas[r.name] = info
        # one fleet-wide timeline list: requests interleave across
        # replicas; order by their first stamp. A disaggregated request
        # appears on BOTH tiers (the prefill engine notes it at export,
        # the decode engine at first token) — same trace, snapshotted
        # at two moments — keep the fuller one. NOTE the per-engine
        # deques are bounded (64 each) — under sustained traffic this
        # is the TAIL, not history.
        by_trace = {}
        for tl in recent:
            cur = by_trace.get(tl["trace_id"])
            if cur is None or len(tl.get("phases", ())) >= len(
                    cur.get("phases", ())):
                by_trace[tl["trace_id"]] = tl
        recent = sorted(by_trace.values(),
                        key=lambda tl: tl["phases"][0]["t"]
                        if tl.get("phases") else 0.0)
        # tier-aware autoscale signals: fold the per-replica kv_tier
        # snapshots into ONE fleet block with hit and spill-pressure
        # rates (`_tier_block`, the fold `_autoscale_tick` reads; None
        # when no replica runs a tier)
        kv_tier = self._tier_block(
            (info.get("engine") or {}).get("kv_tier")
            for info in replicas.values())
        snap.update({
            "inflight": inflight,
            "kv_tier": kv_tier,
            "affinity_hit_rate": hits / reqs if reqs else None,
            "ttft_p50_s": self.ttft_quantile(0.5),
            "ttft_p95_s": self.ttft_quantile(0.95),
            "ttft_p99_s": self.ttft_quantile(0.99),
            "request_phase_seconds": _reqtrace.phase_summary(),
            "recent_requests": recent[-128:],
            "replica_ages": self.registry.ages(),
            "replicas": replicas,
            "overload": {
                "breaker": self._breaker.snapshot(),
                "brownout": self._brownout_ctl.snapshot(),
                "estimator": self._estimator.snapshot(),
            },
        })
        return snap

    def start_metrics_http(self, port=0, host="127.0.0.1"):
        """Fleet-wide pull endpoint: GET /metrics is the process
        registry (per-replica pt_replica_* series included) in
        Prometheus text, /metrics.json adds this router's `metrics()`
        under "extra". Stopped with the router."""
        if self._http is None:
            from ...observability import start_http_server

            self._http = start_http_server(port=port, host=host,
                                           extra_json=self.metrics)
        return self._http


_scale_names = itertools.count(1000)   # factory-built replica names
