"""Deterministic, seeded fault injection (counterpart of
paddle_tpu/distributed/chaos.py, the port's own copy: the same plan
format, the same seeded schedule, so a plan written for the reference
fires at the same call indices here). The port wires the transport
scopes (``kv.*``, ``sock.*``: distributed/xproc.py), the train-step
scopes (``step``, ``step.nan``: resilience.StepGuard and
DivergenceSentinel) and the ``replica.kill`` scopes
(inference/fleet_serving/replica.py) and the checkpoint scopes
(``ckpt.*``: distributed/checkpoint.py). Every injection is
journaled as ``chaos_injected`` in the per-rank anomaly journal
(distributed/resilience.py).

A :class:`FaultPlan` of scoped injectors is activated by the
``PT_CHAOS_PLAN`` environment variable (a JSON object) or
programmatically via :func:`install`.

Design rules:

- **Deterministic.** Whether call *n* of scope *s* fires is a pure
  function of ``(seed, s, n)`` (sha256-derived uniform against ``p``, or
  an explicit ``at`` index list) — the same plan yields the identical
  fault schedule on every run, so a chaos failure reproduces.
- **Zero overhead when off.** ``fire()`` is a single ``is None`` check
  when no plan is installed; no env read after the first call.
- **Crash-once across restarts.** An injector with ``once: true`` claims
  a marker file in ``state_dir`` (or ``$PT_CHAOS_STATE``) *before*
  executing, so a crash injector that killed the pod does not re-kill
  the restarted pod at the same call index forever.

Scopes of the reference's stack:

==================  =====================================================
scope               injection point
==================  =====================================================
``kv.get``          coordination-KV blocking gets (xproc._kv_get)
``kv.set``          coordination-KV sets (endpoint publication, kv p2p)
``sock.connect``    p2p transport connection establishment
``sock.send``       p2p frame send (stall or pre-write drop)
``sock.recv``       p2p frame receive (stall)
``ckpt.snapshot``   checkpoint SNAPSHOT phase, on the step path (one
                    call per save, after host materialization, before
                    the commit is handed off)
``ckpt.commit``     checkpoint COMMIT phase entry (background thread
                    under async_save) — call n = this rank's nth commit
``ckpt.commit.<r>`` same tick, but only rank r fires its own scope —
                    the way a FaultPlan SIGKILLs exactly one rank
                    mid-commit (busy-tick counting like
                    ``replica.kill.<name>``)
``ckpt.kill_window``between this rank's shard write and its DONE.<rank>
                    commit marker (THE torn-commit window)
``step``            train-step entry (crash/hang at step N; fired by
                    StepGuard.check AND DivergenceSentinel.check)
``step.dispatch``   inside the instrumented train step, between its
                    ``h2d`` and ``dispatch`` phase stamps — a
                    rank-scoped delay here is how the steptrace
                    straggler chaos test makes ONE rank slow in ONE
                    attributable phase (observability.steptrace)
``step.nan``        StepGuard/DivergenceSentinel loss poisoning
                    (NaN/Inf grad shape)
``replica.kill``    fleet-replica serve-loop tick (fleet_serving
                    .replica): a fired injector stops that replica's
                    loop DEAD — no drain, no future resolution — and
                    the router's failover requeues its in-flight work.
                    ``replica.kill.<name>`` targets one replica.
==================  =====================================================

Injector spec (JSON object inside the plan's ``injectors`` list)::

    {"scope": "kv.get",       # required
     "kind": "error",         # error | delay | crash | hang | nan
     "p": 0.0,                # per-call fire probability (seeded hash)
     "at": [0, 3],            # explicit 0-based call indices (OR with p)
     "ranks": [1],            # restrict to these ranks (default: all)
     "max_fires": 2,          # per-process cap (default: unlimited)
     "once": true,            # at most once per JOB (marker in state_dir)
     "delay_s": 0.25}         # sleep length for delay/hang kinds
                              # (unset: delay=0.1s, hang=wedge 1h)
"""
import hashlib
import json
import os
import signal
import threading
import time

__all__ = ["FaultPlan", "Injector", "InjectedFault", "fire", "poison",
           "install", "clear", "get_plan", "active",
           "ENV_PLAN", "ENV_STATE"]

ENV_PLAN = "PT_CHAOS_PLAN"
ENV_STATE = "PT_CHAOS_STATE"

KINDS = ("error", "delay", "crash", "hang", "nan")


class InjectedFault(OSError):
    """A chaos-injected failure. Subclasses OSError so the generic
    transient-fault handlers (resilience.RetryPolicy default retry_on)
    treat it exactly like a real I/O fault."""

    def __init__(self, scope, n, kind="error"):
        super().__init__(f"chaos: injected {kind} (scope={scope} call={n})")
        self.scope = scope
        self.n = n
        self.kind = kind


_rank_cache = None


def _rank():
    """Worker rank for rank-scoped injectors. The launcher env contract
    (PADDLE_TRAINER_ID) is authoritative and cheap; in-process tests and
    single-process jobs are rank 0."""
    global _rank_cache
    if _rank_cache is None:
        _rank_cache = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    return _rank_cache


def _hash01(seed, scope, n):
    """Uniform [0,1) from (seed, scope, call-index) — the deterministic
    coin every probabilistic injector flips."""
    h = hashlib.sha256(f"{seed}/{scope}/{n}".encode()).digest()
    return int.from_bytes(h[:8], "big") / 2.0 ** 64


class Injector:
    def __init__(self, scope, kind="error", p=0.0, at=(), ranks=None,
                 max_fires=None, once=False, delay_s=None, index=0):
        if kind not in KINDS:
            raise ValueError(f"unknown injector kind {kind!r}; "
                             f"expected one of {KINDS}")
        self.scope = scope
        self.kind = kind
        self.p = float(p)
        self.at = frozenset(int(i) for i in at)
        self.ranks = None if ranks is None else frozenset(
            int(r) for r in ranks)
        self.max_fires = max_fires
        self.once = bool(once)
        # None = unset: 'delay' defaults to a 0.1s stall, 'hang' to a
        # wedge (1h). An EXPLICIT delay_s is always honored verbatim —
        # a requested 50ms hang must not silently become an hour.
        self.delay_s = None if delay_s is None else float(delay_s)
        self.index = index          # position in the plan (marker naming)
        self.fires = 0              # per-process fire count

    def matches(self, seed, n, rank):
        """Pure decision: would call `n` of this scope on `rank` fire?
        (Ignores per-process max_fires and cross-restart once-markers —
        those are stateful filters applied by FaultPlan.fire.)"""
        if self.ranks is not None and rank not in self.ranks:
            return False
        if n in self.at:
            return True
        return self.p > 0.0 and _hash01(seed, self.scope, n) < self.p

    def spec(self):
        d = {"scope": self.scope, "kind": self.kind}
        if self.p:
            d["p"] = self.p
        if self.at:
            d["at"] = sorted(self.at)
        if self.ranks is not None:
            d["ranks"] = sorted(self.ranks)
        if self.max_fires is not None:
            d["max_fires"] = self.max_fires
        if self.once:
            d["once"] = True
        if self.kind in ("delay", "hang") and self.delay_s is not None:
            d["delay_s"] = self.delay_s
        return d


class FaultPlan:
    """A seeded set of scoped injectors. ``fire(scope)`` counts the call
    and executes the matching injector's action (raise / sleep / die);
    ``schedule`` exposes the pure decision function for determinism
    tests and pre-flight inspection."""

    def __init__(self, injectors=(), seed=0, state_dir=None):
        self.seed = int(seed)
        self.state_dir = state_dir or os.environ.get(ENV_STATE) or None
        self.injectors = []
        for i, spec in enumerate(injectors):
            if isinstance(spec, Injector):
                spec.index = i
                self.injectors.append(spec)
            else:
                self.injectors.append(Injector(index=i, **spec))
        self._counts = {}
        # scopes fire from concurrent threads (io-pool sends, the
        # heartbeat) — the counter read-modify-write must be atomic or
        # call indices get double-assigned and the deterministic
        # schedule silently diverges between runs
        self._lock = threading.Lock()
        self._by_scope = {}
        for inj in self.injectors:
            self._by_scope.setdefault(inj.scope, []).append(inj)
        self.injected = {}          # scope -> executed-injection count

    # ---- (de)serialization --------------------------------------------
    @classmethod
    def from_json(cls, text):
        spec = json.loads(text)
        return cls(injectors=spec.get("injectors", ()),
                   seed=spec.get("seed", 0),
                   state_dir=spec.get("state_dir"))

    def to_json(self):
        d = {"seed": self.seed,
             "injectors": [inj.spec() for inj in self.injectors]}
        if self.state_dir:
            d["state_dir"] = self.state_dir
        return json.dumps(d)

    # ---- pure schedule view -------------------------------------------
    def schedule(self, scope, n_calls, rank=None):
        """Call indices in [0, n_calls) that would fire for `scope` —
        the deterministic fault schedule (same seed → same list)."""
        rank = _rank() if rank is None else rank
        out = []
        for n in range(n_calls):
            if any(inj.matches(self.seed, n, rank)
                   for inj in self._by_scope.get(scope, ())):
                out.append(n)
        return out

    # ---- stateful firing ----------------------------------------------
    def _claim_once(self, inj):
        """Cross-restart at-most-once: atomically create the injector's
        marker file. False means some incarnation already fired it."""
        if not self.state_dir:
            # no durable state: degrade to per-process at-most-once
            return inj.fires == 0
        os.makedirs(self.state_dir, exist_ok=True)
        marker = os.path.join(
            self.state_dir, f"chaos_fired.{inj.index}."
            f"{''.join(c if c.isalnum() else '-' for c in inj.scope)}")
        try:
            fd = os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        os.close(fd)
        return True

    def fire(self, scope):
        """Count one call of `scope`; execute the matching injector's
        action if the schedule says this call fires. Returns the
        Injector executed (kind 'nan' is returned, not executed — the
        caller poisons its own value) or None."""
        chosen = None
        with self._lock:
            n = self._counts.get(scope, 0)
            self._counts[scope] = n + 1
            rank = _rank()
            for inj in self._by_scope.get(scope, ()):
                if not inj.matches(self.seed, n, rank):
                    continue
                if (inj.max_fires is not None
                        and inj.fires >= inj.max_fires):
                    continue
                if inj.once and not self._claim_once(inj):
                    continue
                inj.fires += 1
                self.injected[scope] = self.injected.get(scope, 0) + 1
                chosen = inj
                break
        if chosen is None:
            return None
        # execute OUTSIDE the lock: a delay/hang injector sleeping with
        # it held would stall every other scope's call accounting
        self._journal(chosen, n)
        return self._execute(chosen, scope, n)

    def _journal(self, inj, n):
        # the anomaly journal mirrors the event into the flight
        # recorder's ring; journaling must never break the injection
        try:
            from . import resilience

            resilience.record("chaos_injected", scope=inj.scope,
                              fault=inj.kind, call=n)
        except Exception:
            pass

    def _execute(self, inj, scope, n):
        if inj.kind == "delay":
            time.sleep(0.1 if inj.delay_s is None else inj.delay_s)
            return inj
        if inj.kind == "error":
            raise InjectedFault(scope, n, "error")
        if inj.kind == "crash":
            # SIGKILL, the most faithful preemption/OOM shape: no atexit,
            # no finally blocks, no flushing — exactly what the atomic
            # checkpoint commit must survive
            os.kill(os.getpid(), signal.SIGKILL)
            time.sleep(60)          # unreachable; parachute for signals
            return inj
        if inj.kind == "hang":
            time.sleep(3600.0 if inj.delay_s is None else inj.delay_s)
            return inj
        return inj                  # "nan": caller poisons its value


# ---------------------------------------------------------------- module

_PLAN = None
_LOADED = False


def get_plan():
    """The active plan: an installed one, else PT_CHAOS_PLAN from the
    environment (read once), else None."""
    global _PLAN, _LOADED
    if not _LOADED:
        _LOADED = True
        spec = os.environ.get(ENV_PLAN)
        if spec:
            _PLAN = FaultPlan.from_json(spec)
    return _PLAN


def install(plan):
    """Install `plan` (a FaultPlan, JSON text, or dict) for this process."""
    global _PLAN, _LOADED
    if isinstance(plan, str):
        plan = FaultPlan.from_json(plan)
    elif isinstance(plan, dict):
        plan = FaultPlan(injectors=plan.get("injectors", ()),
                         seed=plan.get("seed", 0),
                         state_dir=plan.get("state_dir"))
    _PLAN = plan
    _LOADED = True
    return plan


def clear():
    """Deactivate chaos (and forget the env read, so tests that set
    PT_CHAOS_PLAN afterwards are re-read)."""
    global _PLAN, _LOADED, _rank_cache
    _PLAN = None
    _LOADED = False
    _rank_cache = None


def active():
    return get_plan() is not None


def fire(scope):
    """The hook fault paths call. No plan → a single attribute check."""
    plan = _PLAN if _LOADED else get_plan()
    if plan is None:
        return None
    return plan.fire(scope)


def poison(value, scope="step.nan"):
    """NaN/Inf poisoning hook (grad/loss shape): returns NaN when the
    scope's injector fires for this call, else `value` unchanged."""
    plan = _PLAN if _LOADED else get_plan()
    if plan is None:
        return value
    if plan.fire(scope) is not None:
        return float("nan")
    return value
