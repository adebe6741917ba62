"""SLA-aware multi-tenant scheduler — admission policy for `LLMEngine`
(counterpart of paddle_tpu/inference/fleet_serving/scheduler.py, host
Python copied; its `pt_sched_*` metrics live in the port's registry).

Three composed policies, all on the host:

* Priority classes — `Priority.INTERACTIVE < STANDARD < BATCH` (lower
  value = more urgent); within a class tenants share; within a tenant,
  FIFO.
* Per-tenant token-budget fair queuing — each tenant accrues the flat
  tokens the engine spent on it, divided by its weight; among
  same-priority tenants the least-served tenant's head admits next.
* TTFT SLO deadline boost — a request whose wait exceeds
  `slo_boost_fraction × slo` escalates above every class, earliest
  deadline first.

Preemption asks `pick_victim` for the lowest-priority running sequence
(tie: youngest admission). With speculative windows the engine reports
each window's wall time (`note_boundary`), and the SLO check looks that
far ahead (`boundary_lag_s`). With every request on the default tenant and
priority all three policies degrade to exact FIFO plus preempt-youngest.
"""
import collections
import itertools

from ...observability import metrics as _obs

__all__ = ["Priority", "SLAPolicy", "SLAScheduler"]

_PREEMPTIONS = _obs.counter(
    "pt_sched_preemptions",
    "scheduler preemptions: evict-and-requeue of a running sequence",
    labelnames=("reason",))
_SLO_FIRST_TOKENS = _obs.counter(
    "pt_sched_slo_first_tokens",
    "first tokens of SLO-carrying requests, by TTFT outcome",
    labelnames=("outcome",))
_SLO_ATTAINMENT = _obs.gauge(
    "pt_sched_ttft_slo_attainment",
    "TTFT SLO attainment: met / (met + missed), process-cumulative")


class Priority:
    """Admission urgency classes (lower value = more urgent)."""
    INTERACTIVE = 0
    STANDARD = 1
    BATCH = 2


class SLAPolicy:
    """default_ttft_slo_s  TTFT SLO for requests that carry none
    slo_boost_fraction  fraction of the SLO a request may wait before it
                        escalates above every priority class
    tenant_weights      {tenant: weight} for fair queuing (default 1.0)
    """

    def __init__(self, default_ttft_slo_s=None, slo_boost_fraction=0.7,
                 tenant_weights=None):
        self.default_ttft_slo_s = default_ttft_slo_s
        self.slo_boost_fraction = float(slo_boost_fraction)
        if not 0.0 < self.slo_boost_fraction <= 1.0:
            raise ValueError("slo_boost_fraction must be in (0, 1]")
        self.tenant_weights = dict(tenant_weights or {})
        for t, w in self.tenant_weights.items():
            if w <= 0:
                raise ValueError(f"tenant {t!r} weight must be > 0")

    def weight(self, tenant):
        return float(self.tenant_weights.get(tenant, 1.0))

    def slo_for(self, req):
        slo = getattr(req, "ttft_slo_s", None)
        return self.default_ttft_slo_s if slo is None else slo


class SLAScheduler:
    """Waiting-queue policy for `LLMEngine`. One deque per (priority,
    tenant); `pop_next` scans queue heads only (plus escalated members
    when TTFT SLOs are in play)."""

    # fair-queuing meters kept at most (tenant ids are client-supplied)
    _MAX_TENANT_METERS = 10000

    def __init__(self, policy=None):
        self.policy = policy or SLAPolicy()
        self._q = {}      # (priority, tenant) -> deque of requests
        self._used = collections.defaultdict(float)  # tenant -> tokens/w
        self._arrival = itertools.count()
        self._n = 0
        self._n_slo = 0   # waiting requests that can still escalate
        # window-boundary granularity: with speculative windows the
        # engine consults the scheduler once per window, so an escalation
        # point crossed mid-window would be noticed one window late. The
        # engine feeds the measured window wall time here (an EMA) and
        # _at_risk looks that far ahead.
        self.boundary_lag_s = 0.0
        self.stats = {"preemptions_pool": 0, "preemptions_priority": 0,
                      "slo_met": 0, "slo_missed": 0,
                      "spec_proposed": 0, "spec_accepted": 0}

    @property
    def _any_slo(self):
        return (self.policy.default_ttft_slo_s is not None
                or self._n_slo > 0)

    @staticmethod
    def _counts_slo(req):
        return (getattr(req, "ttft_slo_s", None) is not None
                and getattr(req, "t_first_token", None) is None)

    def __len__(self):
        return self._n

    def __bool__(self):
        return self._n > 0

    def __iter__(self):
        """Waiting requests in plain queue order (snapshots of the queues,
        so an insert cannot break the iteration)."""
        for dq in list(self._q.values()):
            yield from tuple(dq)

    # ---- enqueue side ----

    def enqueue(self, req):
        if getattr(req, "_arrival", None) is None:
            req._arrival = next(self._arrival)
        if self._counts_slo(req):
            self._n_slo += 1
        self._dq(req).append(req)
        self._n += 1

    def push_front(self, req):
        """Return a popped-but-not-admitted (or preempted) request to the
        head of its class queue, keeping its arrival stamp."""
        if self._counts_slo(req):
            self._n_slo += 1
        self._dq(req).appendleft(req)
        self._n += 1

    def _dq(self, req):
        key = (int(req.priority), req.tenant)
        dq = self._q.get(key)
        if dq is None:
            dq = self._q[key] = collections.deque()
        return dq

    def remove(self, req):
        """Remove one specific waiting request (single-request abort /
        deadline expiry). False when it is not queued here — already
        admitted to a slot, or already finished."""
        key = (int(req.priority), req.tenant)
        dq = self._q.get(key)
        if dq is None:
            return False
        try:
            dq.remove(req)
        except ValueError:
            return False
        self._n -= 1
        if not dq:
            del self._q[key]        # same key hygiene as pop_next
        if self._counts_slo(req):
            self._n_slo -= 1
        return True

    def drain(self):
        """Pop every waiting request (abort path)."""
        out = []
        for dq in list(self._q.values()):
            out.extend(dq)
        self._q.clear()
        self._n = 0
        self._n_slo = 0
        return out

    # ---- admission order ----

    def _at_risk(self, req, now):
        # TTFT is a first-token target: once a request has produced one,
        # escalation ends (keeping it escalated would livelock preemption)
        if getattr(req, "t_first_token", None) is not None:
            return None
        slo = self.policy.slo_for(req)
        if slo is None:
            return None
        # boundary clamp: escalation checks run at window boundaries, so
        # look one expected window ahead
        waited = now - req.t_submit + self.boundary_lag_s
        if waited >= self.policy.slo_boost_fraction * float(slo):
            return req.t_submit + float(slo)  # deadline
        return None

    def _eff_priority(self, req, now):
        """Priority with SLO escalation folded in (-1 = escalated)."""
        return (-1 if self._at_risk(req, now) is not None
                else int(req.priority))

    def _order_key(self, req, now):
        deadline = self._at_risk(req, now)
        if deadline is not None:
            return (-1, deadline, req._arrival)
        return (int(req.priority), self._used.get(req.tenant, 0.0),
                req._arrival)

    def pop_next(self, now):
        """Most-urgent waiting request, or None: SLO-escalated first
        (earliest deadline), then priority class, then least-served
        tenant, then arrival order."""
        best_key, best_q, best_i = None, None, None
        for key, dq in list(self._q.items()):
            if not dq:
                continue
            candidates = enumerate(dq) if self._any_slo else ((0, dq[0]),)
            for i, r in candidates:
                k = self._order_key(r, now)
                if i and k[0] != -1:
                    continue   # buried + not escalated: FIFO holds
                if best_key is None or k < best_key:
                    best_key, best_q, best_i = k, key, i
        if best_q is None:
            return None
        self._n -= 1
        dq = self._q[best_q]
        req = dq[best_i]
        del dq[best_i]
        if not dq:
            del self._q[best_q]
        if self._counts_slo(req):
            self._n_slo -= 1
        return req

    # ---- preemption ----

    def pick_victim(self, slots, keep=None, worse_than=None, now=0.0,
                    allow_equal=False):
        """(slot, request) to evict-and-requeue, or None. Victim = lowest
        priority (max value), tie-broken youngest (max admit_seq); `keep`
        is never picked. `worse_than` demands a victim strictly less
        urgent than it (or equally urgent with `allow_equal`)."""
        victim, vslot, vkey = None, None, None
        for slot, req in enumerate(slots):
            if req is None or req is keep:
                continue
            key = (self._eff_priority(req, now), req.admit_seq)
            if victim is None or key > vkey:
                victim, vslot, vkey = req, slot, key
        if victim is None:
            return None
        if worse_than is not None:
            cand = self._eff_priority(worse_than, now)
            if vkey[0] < cand or (vkey[0] == cand and not allow_equal):
                return None
        return vslot, victim

    def less_urgent(self, a, b, now=0.0):
        """True when running sequence `a` is strictly less urgent than
        admission candidate `b` (a legal preemption victim for it)."""
        return self._eff_priority(a, now) > self._eff_priority(b, now)

    def note_preemption(self, reason):
        self.stats[f"preemptions_{reason}"] += 1
        _PREEMPTIONS.labels(reason=reason).inc()

    def note_spec_window(self, proposed, accepted):
        """Per-window speculative accounting (once per verify step):
        proposals sent vs accepted."""
        self.stats["spec_proposed"] += int(proposed)
        self.stats["spec_accepted"] += int(accepted)

    def note_boundary(self, window_s):
        """EMA of a decode window's wall time (once per window), read by
        `_at_risk`. Capped at 1 s: a one-off stall must not escalate
        every SLO request a second early for good."""
        w = min(float(window_s), 1.0)
        self.boundary_lag_s = (w if self.boundary_lag_s == 0.0
                               else 0.5 * self.boundary_lag_s + 0.5 * w)

    # ---- accounting ----

    def note_tokens(self, tenant, n):
        """Charge `n` flat tokens to the tenant's fair-queuing meter."""
        self._used[tenant] += n / self.policy.weight(tenant)
        if len(self._used) > self._MAX_TENANT_METERS:
            keep = sorted(self._used.items(), key=lambda kv: kv[1],
                          reverse=True)[:self._MAX_TENANT_METERS // 2]
            self._used = collections.defaultdict(float, keep)

    def note_first_token(self, req, ttft_s):
        slo = self.policy.slo_for(req)
        if slo is None:
            return
        met = ttft_s <= float(slo)
        self.stats["slo_met" if met else "slo_missed"] += 1
        _SLO_FIRST_TOKENS.labels(outcome="met" if met else "missed").inc()
        # process-cumulative: derived from the registry's counters, so
        # several engines in one process do not overwrite each other
        n_met = _SLO_FIRST_TOKENS.labels(outcome="met").value
        n_missed = _SLO_FIRST_TOKENS.labels(outcome="missed").value
        if n_met + n_missed:
            _SLO_ATTAINMENT.set(n_met / (n_met + n_missed))

    def snapshot(self):
        """Metrics view for `LLMEngine.metrics()`."""
        depths = {f"{prio}:{tenant}": len(dq)
                  for (prio, tenant), dq in list(self._q.items()) if dq}
        met, missed = self.stats["slo_met"], self.stats["slo_missed"]
        top = sorted(list(self._used.items()), key=lambda kv: kv[1],
                     reverse=True)[:32]
        return {
            "waiting": self._n,
            "boundary_lag_s": round(self.boundary_lag_s, 6),
            "queue_depths": depths,
            "tenant_meters": len(self._used),
            "tenant_used_tokens": {t: round(u, 1) for t, u in top},
            "preemptions_pool": self.stats["preemptions_pool"],
            "preemptions_priority": self.stats["preemptions_priority"],
            "spec_proposed": self.stats["spec_proposed"],
            "spec_accepted": self.stats["spec_accepted"],
            "spec_acceptance": (
                self.stats["spec_accepted"] / self.stats["spec_proposed"]
                if self.stats["spec_proposed"] else None),
            "slo_met": met, "slo_missed": missed,
            "slo_attainment": (met / (met + missed)
                               if met + missed else None),
        }
