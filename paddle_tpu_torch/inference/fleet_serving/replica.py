"""Replica runtime — one serving engine as a fleet member (counterpart
of paddle_tpu/inference/fleet_serving/replica.py).

One `LLMServer` owns one engine; a fleet runs N of them behind a router.
This module is the member side of that tier:

* **LocalReplica** wraps a model + `LLMServer` (its own engine thread)
  and registers into a `ReplicaRegistry` with per-tick heartbeats.

* **Roles.** A `role="prefill"` replica only runs prefill-only requests
  (`submit_prefill` → `KVPagePayload`); a `role="serve"` replica
  decodes — from scratch or from an imported payload
  (`submit_imported`). The split is policy, not mechanism: every
  replica's engine can do both, the router routes by role.

* **Chaos kill.** Each busy serve-loop tick fires the `replica.kill`
  and `replica.kill.<name>` chaos scopes (distributed/chaos.py); an
  injector there stops the loop dead — no drain, no future resolution,
  heartbeats cease — the process-death shape. `kill()` does the same
  programmatically. The router's failover requeues the replica's
  in-flight work and greedy replay keeps outputs token-identical.

On the card the replicas of one process share the GPU: each engine
steps on its own CUDA stream (so K1's per-stream workspace is never
shared) and under the engine's device gate (a graph capture of one
replica pauses the others at a step boundary; inference/llm_engine.py).
`fork_model` gives each replica its own copy of the weights.

* **Membership files.** Given a directory, the registry mirrors beats
  into the launcher's `hb_<rank>` file protocol
  (`distributed.fleet.elastic.touch_heartbeat` / `remove_heartbeat`),
  so an `ElasticManager` pointed at the same directory observes the
  serving fleet exactly as it observes a training pod.

* **Cross-process streams.** `stream_prefill` / `recv_and_decode` are
  the xproc-transport halves of the disaggregated hand-off: finished KV
  pages ride `kv_transfer.send_kv_payload` over the p2p socket path —
  RetryPolicy reconnect / resend and the `sock.send` / `sock.recv`
  chaos scopes included. Each rank has its own CUDA context; two ranks
  may share one card (paddle_tpu_torch/profile_disagg.py).
"""
import copy
import itertools
import threading
import time

import numpy as np

from ...distributed import chaos
from ...observability import metrics as _obs
from ...observability import tracing as _tracing

__all__ = ["ReplicaRegistry", "LocalReplica", "fork_model",
           "stream_prefill", "recv_and_decode"]

_REPLICA_LIVE = _obs.gauge(
    "pt_router_replica_live",
    "replicas currently alive in the registry (heartbeat fresh, loop "
    "running) — the fleet-capacity gauge the autoscaler moves")
_REPLICA_QUEUE = _obs.gauge(
    "pt_replica_queue_depth",
    "per-replica waiting requests (engine queue + server inbox), "
    "refreshed every serve-loop tick — the fleet-wide /metrics view's "
    "per-member load signal (series removed on retirement/death)",
    labelnames=("replica",))
_REPLICA_OCC = _obs.gauge(
    "pt_replica_slot_occupancy",
    "per-replica live slots / num_slots, refreshed every serve-loop "
    "tick (series removed on retirement/death)",
    labelnames=("replica",))

_replica_ids = itertools.count()


def fork_model(model):
    """A private copy of `model` for a new replica: a module of the same
    class and config with every parameter and buffer copied, on the same
    device (quantized weight-only linears included). The fork shares no
    mutable state with the source."""
    m = copy.deepcopy(model)
    m.eval()
    return m


class ReplicaRegistry:
    """Heartbeat membership for a replica fleet (elastic-style: the
    registry IS the `hb_<rank>` view, held in-process with an optional
    file mirror for cross-process observers)."""

    def __init__(self, hb_dir=None, timeout_s=2.0):
        self._lock = threading.Lock()
        self._members = {}   # name -> {"replica", "rid", "beat"}
        self.hb_dir = hb_dir
        self.timeout_s = float(timeout_s)

    def register(self, replica):
        with self._lock:
            self._members[replica.name] = {
                "replica": replica, "rid": replica.rid,
                "beat": time.monotonic()}
        self._mirror(replica.rid)
        self._publish()

    def deregister(self, name):
        with self._lock:
            entry = self._members.pop(name, None)
        if entry is not None and self.hb_dir:
            from ...distributed.fleet.elastic import remove_heartbeat

            remove_heartbeat(self.hb_dir, entry["rid"])
        self._publish()

    def beat(self, name):
        with self._lock:
            entry = self._members.get(name)
            if entry is None:
                return
            entry["beat"] = time.monotonic()
            rid = entry["rid"]
        self._mirror(rid)

    def _mirror(self, rid):
        if self.hb_dir:
            from ...distributed.fleet.elastic import touch_heartbeat

            touch_heartbeat(self.hb_dir, rid)

    def ages(self):
        """name -> seconds since the last beat (scrape-safe snapshot)."""
        now = time.monotonic()
        with self._lock:
            return {name: now - e["beat"]
                    for name, e in list(self._members.items())}

    def alive(self, name):
        """Alive = loop running AND heartbeat inside the timeout — a
        wedged loop (hang injector) goes dead by staleness even though
        its thread still exists."""
        with self._lock:
            entry = self._members.get(name)
            if entry is None:
                return False
            fresh = time.monotonic() - entry["beat"] <= self.timeout_s
            return fresh and entry["replica"].running

    def live(self):
        """Names of alive replicas (snapshot)."""
        return [name for name in list(self._members) if self.alive(name)]

    def _publish(self):
        _REPLICA_LIVE.set(len(self.live()))


def _make_server_class():
    """The replica's `LLMServer` subclass (per-tick heartbeat + chaos
    kill hook), built lazily: fleet_serving loads BEFORE
    inference.llm_engine, so the base class cannot be imported at
    module level."""
    from ..llm_engine import LLMServer

    class _Server(LLMServer):
        _thread_name = "fleet-replica"

        def __init__(self, model, config, replica):
            super().__init__(model, config)
            self._replica = replica

        def _loop(self):
            # every span this serve thread emits carries the replica
            # name — the merged timeline's per-replica lanes
            _tracing.set_replica(self._replica.name)
            try:
                super()._loop()
            finally:
                _tracing.set_replica(None)

        def _tick_hook(self):
            rep = self._replica
            if not rep._killed:
                rep.last_tick = time.monotonic()
                rep._registry.beat(rep.name)
                eng = self._engine
                _REPLICA_QUEUE.labels(replica=rep.name).set(
                    len(eng.waiting) + self._q.qsize())
                _REPLICA_OCC.labels(replica=rep.name).set(
                    sum(r is not None for r in list(eng._slots))
                    / eng.num_slots)
                # the kill scopes count BUSY ticks only: an idle loop
                # polls on a wall-clock cadence, so a seeded call
                # index would name a moment, not a serving state —
                # counting work ticks makes "kill at tick N" mean
                # "mid-stream after N scheduling rounds" on every run
                if eng.has_work() or not self._q.empty():
                    try:
                        chaos.fire("replica.kill")
                        chaos.fire(f"replica.kill.{rep.name}")
                    except chaos.InjectedFault:
                        rep._killed = True
                        # postmortem at the moment of death, from the
                        # dying thread: the ring still holds the
                        # victim requests' phase/span trail
                        rep._flight_dump("chaos_replica_kill")
            # True aborts the loop dead: in-flight futures stay
            # unresolved and heartbeats stop — the router requeues
            return rep._killed

    return _Server


class LocalReplica:
    """One fleet member: model + threaded `LLMServer` + registry
    heartbeat (module docstring). The submit surface returns the
    server's futures unchanged; `metrics()`/`queue_depth()` are the
    router's load signals."""

    def __init__(self, model, name=None, config=None, registry=None,
                 role="serve", warm=True):
        self.rid = next(_replica_ids)
        self.name = name or f"replica{self.rid}"
        self.role = str(role)
        self._registry = registry if registry is not None \
            else ReplicaRegistry()
        self._killed = False
        # monotonic stamp of the last serve-loop tick, kept on the
        # REPLICA (the registry drops a deregistered member's beats):
        # the router's failover recovery needs progress evidence that
        # survives expulsion — a hung thread is `running` but does not
        # tick, so `last_tick` is what distinguishes a cleared wedge
        # from an ongoing one
        self.last_tick = 0.0
        cls = _make_server_class()
        self._server = cls(model, config, self)
        if warm:
            self._warm()
        self._server.start()
        self._registry.register(self)

    @property
    def engine(self):
        return self._server.engine

    @property
    def server(self):
        return self._server

    def _warm(self):
        """Warm the engine in THIS thread before the serve loop starts,
        so one-time setup stays off the serving path: a short request
        long enough to cross one window runs the single tick and the
        fused / speculative window (on the card the window's CUDA graph
        is captured here), then one prefill_only -> import round trip
        runs the KV wire."""
        from ...observability import reqtrace as _reqtrace

        eng = self.engine
        k = max(eng.decode_k,
                eng._spec.k + 1 if eng._spec is not None else 1)
        # quiet traces: the warm requests' segments hold the one-time
        # setup — they must not enter the TTFT phase distribution or the
        # recent-requests view
        req = eng.add_request(np.zeros((2,), np.int32),
                              max_new_tokens=k + 1,
                              trace=_reqtrace.quiet_trace())
        while eng.has_work():
            eng.step()
        req.future.result(timeout=0)
        # and the KV wire: export gather + import scatter
        pr = eng.add_request(np.zeros((2,), np.int32),
                             prefill_only=True,
                             trace=_reqtrace.quiet_trace())
        while eng.has_work():
            eng.step()
        ir = eng.import_kv_pages(pr.future.result(timeout=0),
                                 max_new_tokens=1,
                                 trace=_reqtrace.quiet_trace())
        while eng.has_work():
            eng.step()
        ir.future.result(timeout=0)
        eng.stats.update({"steps": 0, "tokens_in": 0, "generated": 0,
                          "finished": 0, "occupancy_sum": 0.0,
                          "fused_steps": 0, "kv_pages_exported": 0,
                          "kv_pages_imported": 0, "prefill_exports": 0})

    # ---- submit surface (thread-safe: LLMServer queue) ----

    def submit(self, prompt, **kw):
        return self._server.submit(prompt, **kw)

    def submit_prefill(self, prompt, **kw):
        """Future -> KVPagePayload (the disaggregated prefill half)."""
        kw.pop("max_new_tokens", None)  # ignored by prefill-only
        return self._server.submit(prompt, prefill_only=True, **kw)

    def submit_imported(self, payload, **kw):
        """Future -> tokens, decoding from an imported payload's
        frontier (the disaggregated decode half)."""
        return self._server.submit(payload.tokens, kv_import=payload,
                                   **kw)

    def export_prefix(self, tokens):
        """Future -> KVPagePayload (or None): cut this replica's trie
        prefix of `tokens` for a hot-prefix pull (router migration —
        docs/SERVING.md "KV memory hierarchy"). Engine-thread work,
        queued behind in-flight submissions like any control op."""
        return self._server.export_prefix(tokens)

    def abort(self, request_id, reason="client", counted=False):
        """Cancel one in-flight request on this replica's engine
        (cancellation propagation — the overload control plane's
        router `cancel` lands here). Rides the server queue; a
        stopped/killed replica swallows it: the request dies with the
        replica anyway and the router owns the client future."""
        try:
            self._server.abort(request_id, reason=reason, counted=counted)
        except RuntimeError:
            pass   # server not started / already stopped

    # ---- liveness / load ----

    @property
    def running(self):
        t = self._server._thread
        return (not self._killed and self._server._running
                and t is not None and t.is_alive())

    @property
    def alive(self):
        return self._registry.alive(self.name)

    def queue_depth(self):
        eng = self.engine
        return len(eng.waiting) + self._server._q.qsize()

    def load(self):
        """(queue_depth, live-slot occupancy): the least-loaded order
        the router's fallback uses."""
        eng = self.engine
        live = sum(r is not None for r in list(eng._slots))
        return (self.queue_depth(), live / eng.num_slots)

    def metrics(self):
        out = self.engine.metrics()
        out["replica"] = {"name": self.name, "rid": self.rid,
                          "role": self.role, "alive": self.alive,
                          "queue_depth": self.queue_depth()}
        return out

    # ---- lifecycle ----

    def _flight_dump(self, reason):
        """Postmortem into the flight recorder (best-effort): the dead
        member's name plus the requests it was holding, with their trace
        ids — what the failover's requeue is about to replay."""
        try:
            from ...observability import flight_recorder as _fr

            eng = self.engine
            inflight = [{"rid": r.rid, "trace_id": r.trace.trace_id}
                        for r in list(eng._slots) if r is not None]
            _fr.dump(reason, replica=self.name, role=self.role,
                     inflight=inflight, queued=len(eng.waiting))
        except Exception:
            pass   # a postmortem must never take the dying loop down

    def _drop_gauges(self):
        """Remove this replica's labeled gauge series — a dead/retired
        member must not export frozen last-tick values forever."""
        _REPLICA_QUEUE.remove(replica=self.name)
        _REPLICA_OCC.remove(replica=self.name)

    def export_telemetry(self, directory=None):
        """Per-replica telemetry file (`metrics.rank<r>.<name>.json`):
        threaded replicas share one rank, so naming by replica keeps
        every member's final view (observability.export_replica)."""
        from ...observability import export_replica

        return export_replica(self.name, self.metrics, directory)

    def kill(self):
        """Die like a lost process: the serve loop exits at its next
        tick without resolving anything, heartbeats stop. (The chaos
        `replica.kill` injector lands here too.)"""
        self._killed = True
        self._flight_dump("replica_kill")

    def stop(self):
        """Graceful retirement (scale-down): drain the queue, stop the
        loop, deregister."""
        self._server.stop()
        self._registry.deregister(self.name)
        self._drop_gauges()


# ---- cross-process disaggregation (xproc transport) ----

def stream_prefill(replica, prompt, dst, tag=None, timeout_ms=600_000,
                   **kw):
    """Prefill `prompt` on `replica` and stream the finished KV pages
    to rank `dst` over the p2p socket path (kv_transfer module
    docstring: byte-for-byte, RetryPolicy + chaos-injectable). Returns
    the payload's page count."""
    from .kv_transfer import KV_STREAM_TAG, send_kv_payload

    payload = replica.submit_prefill(prompt, **kw).result()
    send_kv_payload(payload, dst,
                    tag=KV_STREAM_TAG if tag is None else tag,
                    timeout_ms=timeout_ms)
    return payload.num_pages


def recv_and_decode(replica, src, tag=None, timeout_ms=600_000, **kw):
    """Receive one streamed payload from rank `src` and admit it on
    `replica` at its frontier. Returns the decode future."""
    from .kv_transfer import KV_STREAM_TAG, recv_kv_payload

    payload = recv_kv_payload(src,
                              tag=KV_STREAM_TAG if tag is None else tag,
                              timeout_ms=timeout_ms)
    return replica.submit_imported(payload, **kw)
