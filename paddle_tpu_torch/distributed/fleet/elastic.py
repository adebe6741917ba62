"""Elastic membership (counterpart of
paddle_tpu/distributed/fleet/elastic.py; the same heartbeat and join
file protocol, gauges and statuses).

The pieces:

- the launcher's pod babysitting (`launch --max_restart`,
  `--elastic_level`: restart, scale-in, scale-out on join requests);
- `ElasticManager`: training or serving code observes the same
  membership signal in-process, from the launcher's membership master
  (`PADDLE_ELASTIC_MASTER`) or the `hb_<rank>` files of the heartbeat
  directory;
- the file protocol itself (`touch_heartbeat`, `remove_heartbeat`,
  `pending_join_files`, `request_scale_out`), which the serving fleet's
  `ReplicaRegistry(hb_dir=...)` publishes through too.

`run_with_fault_tolerance` is the in-process supervision loop over a
`distributed.checkpoint.Checkpointer`: restore the latest complete
checkpoint, re-enter the train function, and on a failure restore again
(a divergence rollback without consuming a restart).
"""
import time

from ...observability import metrics as _obs

__all__ = ["ElasticStatus", "ElasticManager", "run_with_fault_tolerance",
           "request_scale_out", "ELASTIC_EXIT_CODE",
           "touch_heartbeat", "remove_heartbeat"]

# heartbeat telemetry: replaces ad-hoc age prints — the launcher, the
# watch loop, and /metrics scrapes all read the same gauges
_PEER_AGE = _obs.gauge("pt_elastic_peer_age_seconds",
                       "seconds since a peer's last heartbeat",
                       labelnames=("rank",))
_PEERS = _obs.gauge("pt_elastic_peers", "registered peers")
_STALE_PEERS = _obs.gauge("pt_elastic_stale_peers",
                          "peers past the heartbeat timeout")
_TRAIN_RESTARTS = _obs.counter(
    "pt_elastic_train_restarts_total",
    "in-process fault-tolerant restarts (run_with_fault_tolerance)")

ELASTIC_EXIT_CODE = 101  # reference manager.py ELASTIC_EXIT_CODE


class ElasticStatus:
    COMPLETED = "completed"
    ERROR = "error"
    HOLD = "hold"
    RESTART = "restart"
    EXIT = "exit"


class ElasticManager:
    """Pod-membership watcher over the launcher's heartbeat directory
    (reference elastic/manager.py:127 — etcd node registry + TTL
    heartbeats; here the launcher's membership master or heartbeat
    files play that role: every worker touches hb_<rank> each second via
    distributed/env.py:_start_heartbeat, the launcher restarts/shrinks
    the pod on staleness, and this manager lets training code observe
    the same signal in-process)."""

    def __init__(self, args=None, etcd_client=None):
        import os

        self.master_ep = os.environ.get("PADDLE_ELASTIC_MASTER")
        self.enabled = bool(getattr(args, "elastic_level", 0)
                            or self.master_ep
                            or os.environ.get("PADDLE_HEARTBEAT_DIR"))
        self.hb_dir = os.environ.get("PADDLE_HEARTBEAT_DIR")
        self.timeout = float(os.environ.get("PADDLE_ELASTIC_TIMEOUT",
                                            "30"))
        self._status = None

    def pre_hook(self):
        pass

    def _client(self):
        from ..launch.master import MembershipClient

        return MembershipClient(self.master_ep)

    def peers(self):
        """(rank, seconds-since-last-beat) for every registered worker.
        Prefers the cross-host membership master (launch/master.py —
        the reference's etcd registry); falls back to the single-host
        heartbeat directory."""
        import os

        if self.master_ep:
            try:
                return self._gauge_peers(self._client().peers())
            except OSError:
                # master unreachable: the membership VIEW is empty —
                # gauge that (stale last-healthy values lying on
                # /metrics are worse than an honest zero)
                return self._gauge_peers([])
        if not self.hb_dir or not os.path.isdir(self.hb_dir):
            return self._gauge_peers([])   # view empty — gauge it too
        now = time.time()
        out = []
        for f in sorted(os.listdir(self.hb_dir)):
            if not f.startswith("hb_"):
                continue
            try:
                age = now - os.path.getmtime(os.path.join(self.hb_dir, f))
            except OSError:
                continue
            out.append((int(f[3:]), age))
        return self._gauge_peers(out)

    def _gauge_peers(self, peers):
        """Mirror the membership view into the registry heartbeat
        gauges. Ranks that left the view have
        their per-rank series REMOVED — a departed rank frozen at its
        last healthy age would scrape as alive forever."""
        _PEERS.set(len(peers))
        stale = 0
        seen = set()
        for rank, age in peers:
            seen.add(str(rank))
            _PEER_AGE.labels(rank=rank).set(age)
            if age > self.timeout:
                stale += 1
        for gone in set(_PEER_AGE._children) - {(r,) for r in seen}:
            _PEER_AGE.remove(*gone)
        _STALE_PEERS.set(stale)
        return peers

    def watch(self):
        """HOLD while every registered peer beats within the timeout;
        RESTART when one goes stale (the launcher will re-form the pod);
        COMPLETED/ERROR after exit()."""
        if self._status is not None:
            return self._status
        for _, age in self.peers():
            if age > self.timeout:
                return ElasticStatus.RESTART
        return ElasticStatus.HOLD

    def exit(self, completed=True):
        self._status = (ElasticStatus.COMPLETED if completed
                        else ElasticStatus.ERROR)

    def health(self):
        """rank -> {age, degraded, retries}: the degraded-vs-dead view
        the membership master aggregates from heartbeat retry telemetry
        (resilience.recent_failures). Empty without a master endpoint —
        the directory fallback carries liveness only."""
        if self.master_ep:
            try:
                return self._client().health()
            except OSError:
                return {}
        return {}

    def pending_joins(self):
        """Join requests awaiting the launcher (reference ETCDMaster
        node-arrival watch)."""
        if self.master_ep:
            try:
                return self._client().pending_joins()
            except OSError:
                return 0
        return len(pending_join_files(self.hb_dir))


# the heartbeat file protocol (env.py:_start_heartbeat writer,
# ElasticManager.peers / the launcher readers), exposed for OTHER
# heartbeat publishers — the fleet-serving replica runtime
# (inference/fleet_serving/replica.py) registers its replicas through
# these, so a serving fleet's liveness is observable via the SAME
# ElasticManager view as a training pod's
HB_PREFIX = "hb_"


def touch_heartbeat(hb_dir, rank):
    """Write/refresh `hb_<rank>` in the membership directory (same
    format as the worker heartbeat thread: the beat wall-time). Returns
    the path."""
    import os

    os.makedirs(hb_dir, exist_ok=True)
    path = os.path.join(hb_dir, f"{HB_PREFIX}{int(rank)}")
    with open(path, "w") as f:
        f.write(str(time.time()))
    return path


def remove_heartbeat(hb_dir, rank):
    """Tombstone one rank's heartbeat (clean exit must not read as a
    wedged peer — the env.py atexit contract). Idempotent."""
    import os

    try:
        os.unlink(os.path.join(hb_dir, f"{HB_PREFIX}{int(rank)}"))
    except OSError:
        pass


# the join-request file protocol, shared by request_scale_out (writer),
# ElasticManager.pending_joins and the launcher's watch (readers)
JOIN_PREFIX = "join_"


def pending_join_files(hb_dir):
    """Absolute paths of join_* request files in the heartbeat dir."""
    import os

    if not hb_dir or not os.path.isdir(hb_dir):
        return []
    return sorted(
        os.path.join(hb_dir, f) for f in os.listdir(hb_dir)
        if f.startswith(JOIN_PREFIX))


def request_scale_out(n=1, hb_dir=None, master=None):
    """Ask the launcher to admit `n` joining worker(s). A launcher
    running with --elastic_level>=1 tears the pod down (RC_SCALE_OUT)
    and re-forms it with nproc+n contiguous ranks; workers resume from
    the latest complete checkpoint and re-shard
    DistributedBatchSampler at the new world size (reference:
    elastic/manager.py:127 ETCDMaster re-ranks on peer ARRIVAL;
    launch/controllers/master.py:175).

    Transport: with a membership master active (PADDLE_ELASTIC_MASTER,
    or the `master` endpoint argument — e.g. an operator box or second
    "node" that shares NOTHING but the endpoint with the pod), the
    request is one RPC to the launcher's registry. Fallback: join_*
    request files in the shared heartbeat directory (single host).
    Returns n."""
    import os
    import uuid

    master = master or os.environ.get("PADDLE_ELASTIC_MASTER")
    if master:
        from ..launch.master import MembershipClient

        MembershipClient(master).join(n)
        return n
    hb_dir = hb_dir or os.environ.get("PADDLE_HEARTBEAT_DIR")
    if not hb_dir:
        raise RuntimeError(
            "request_scale_out needs a membership master "
            "(PADDLE_ELASTIC_MASTER) or the launcher heartbeat dir "
            "(PADDLE_HEARTBEAT_DIR) — start the job via "
            "paddle_tpu.distributed.launch")
    if int(os.environ.get("PADDLE_NNODES", "1")) > 1:
        raise RuntimeError(
            "file-based request_scale_out is single-node-pod scoped; "
            "multi-node scale-out goes through the membership master "
            "(PADDLE_ELASTIC_MASTER)")
    os.makedirs(hb_dir, exist_ok=True)
    for _ in range(n):
        path = os.path.join(hb_dir, JOIN_PREFIX + uuid.uuid4().hex[:8])
        with open(path, "w") as f:
            f.write(str(time.time()))
    return n


def _drain_checkpointer(checkpointer):
    """Join any in-flight async commit before restoring. A failed
    commit must not abort the recovery itself — its checkpoint simply
    never became COMPLETE and load_latest falls back past it."""
    from ..resilience import record

    try:
        checkpointer.wait()
    except Exception as e:
        record("ckpt_drain_failed", error=repr(e))


def run_with_fault_tolerance(train_fn, checkpointer, max_restarts=3,
                             backoff_s=0.0, on_restart=None, retry=None,
                             manager=None):
    """Run `train_fn(start_step) -> last_step`, restoring from
    `checkpointer` (distributed.checkpoint.Checkpointer) and retrying on
    failure.

    train_fn must checkpoint through `checkpointer` as it goes; on an
    exception the latest COMPLETE checkpoint is loaded (half-written
    ones are invisible by construction — the per-rank DONE marker
    protocol) and train_fn is re-entered at the restored step. Raises
    the last error after max_restarts.

    Two recovery tiers compose here:

    * ``DivergenceRollback`` (a resilience.DivergenceSentinel demanding
      a rollback on NaN/Inf or a loss spike) restores and resumes
      WITHOUT consuming a restart — the sentinel bounds its own budget
      (StepAbort past it), marks the poisoned data window, and the
      re-entered train_fn consults ``sentinel.should_skip(step)`` to
      advance past it. Journaled as ``train_rollback``.
    * any other exception consumes one of `max_restarts` in-process
      restarts — unless `manager` (an ElasticManager) reports a STALE
      PEER, in which case the failure is escalated to the launcher
      immediately (``elastic_escalate``): an in-process retry cannot
      re-form a pod whose member died; `launch --max_restart` can.

    `retry` (a resilience.RetryPolicy) supplies exponential backoff +
    jitter between attempts; the legacy fixed `backoff_s` applies when
    no policy is given. Every restart is journaled to the per-rank
    anomaly log (resilience.record)."""
    from ..resilience import DivergenceRollback, record

    attempt = 0
    while True:
        start = checkpointer.load_latest() or 0
        try:
            return train_fn(start)
        except DivergenceRollback as e:
            record("train_rollback", start_step=start, step=e.step,
                   reason=e.reason)
            # postmortem BEFORE the restore overwrites the live state:
            # the ring holds the journal/span trail that led into the
            # divergence
            try:
                from ...observability import flight_recorder as _fr

                _fr.dump("divergence_rollback", step=e.step,
                         rollback_reason=e.reason, start_step=start,
                         value=str(e.value))
            except Exception:  # the dump must not abort the recovery
                pass
            _drain_checkpointer(checkpointer)
            continue
        except Exception as e:
            attempt += 1
            _TRAIN_RESTARTS.inc()
            record("train_restart", attempt=attempt, start_step=start,
                   error=repr(e))
            if attempt > max_restarts:
                raise
            if manager is not None and getattr(manager, "enabled", False) \
                    and manager.watch() == ElasticStatus.RESTART:
                record("elastic_escalate", attempt=attempt,
                       error=repr(e))
                raise
            _drain_checkpointer(checkpointer)
            if on_restart is not None:
                on_restart(attempt)
            delay = (retry.backoff(attempt - 1) if retry is not None
                     else backoff_s)
            if delay:
                time.sleep(delay)
