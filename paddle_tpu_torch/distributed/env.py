"""Rank/world-size environment contract (counterpart of
paddle_tpu/distributed/env.py).

The launcher (`python -m paddle_tpu_torch.distributed.launch`) hands
each worker the reference's contract: ``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_MASTER``, ``PADDLE_LOCAL_RANK`` and
friends. `ensure_multihost_initialized` turns it into a running
multi-process runtime: a ``torch.distributed.TCPStore`` at
``PADDLE_MASTER`` (the rendezvous and the key-value store the xproc
transport publishes its endpoints in) and a gloo process group over that
store for the host collectives. Before that, and in a one-process job,
the env contract alone answers `get_rank` / `get_world_size`.

Who hosts the store: the launcher binds it itself on a free port and
names that port in ``PADDLE_MASTER`` (with ``PADDLE_MASTER_HOSTED=1``),
so every rank connects as a client and no two concurrent launches can
race for one port. When ``PADDLE_MASTER`` comes from anywhere else, rank
0 hosts the store at that address.
"""
import datetime
import os

__all__ = ["get_rank", "get_world_size", "ParallelEnv",
           "ensure_multihost_initialized"]

# seconds a rank waits at the rendezvous for its peers
RENDEZVOUS_TIMEOUT_S = 300.0

# the store this process's runtime rides (None until initialized)
_runtime = {"store": None}


def _store_of_process_group():
    """The store of a process group someone else initialized."""
    import torch.distributed as dist

    from torch.distributed import distributed_c10d

    return dist.PrefixStore("pt", distributed_c10d._get_default_store())


def store():
    """The job's key-value store (a `torch.distributed.Store`), or None
    when no multi-process runtime is up."""
    if _runtime["store"] is None:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            _runtime["store"] = _store_of_process_group()
    return _runtime["store"]


def ensure_multihost_initialized():
    """Multi-process bring-up: if the launcher env contract names a
    master and >1 trainers, connect to (or, as rank 0 without a
    launcher, host) the TCPStore at PADDLE_MASTER and initialize the
    gloo process group over it (the reference's
    `jax.distributed.initialize`). Every key lives under the pod
    incarnation's prefix (PADDLE_POD_ATTEMPT), so a restarted pod never
    reads a previous incarnation's leftovers from the launcher's store.
    Idempotent; no-op (False) for single-process jobs."""
    world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    master = os.environ.get("PADDLE_MASTER", "")
    if world <= 1 or not master:
        return False
    import torch.distributed as dist

    if _runtime["store"] is None:
        if dist.is_initialized():
            _runtime["store"] = _store_of_process_group()
        else:
            rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
            hosted = os.environ.get("PADDLE_MASTER_HOSTED") == "1"
            host, port = master.rsplit(":", 1)
            timeout = datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S)
            base = dist.TCPStore(
                host, int(port), None if hosted else world,
                is_master=rank == 0 and not hosted, timeout=timeout,
                wait_for_workers=False)
            epoch = os.environ.get("PADDLE_POD_ATTEMPT", "0")
            st = dist.PrefixStore(f"pt/{epoch}", base)
            dist.init_process_group("gloo", store=dist.PrefixStore(
                "pg", st), rank=rank, world_size=world, timeout=timeout)
            _runtime["store"] = st
    _start_heartbeat()
    return True


_hb_thread = None


def _start_heartbeat():
    """Beat every second so the launcher (and ElasticManager peers) can
    tell a HUNG worker from a live one — process liveness alone misses
    wedged collectives.

    Two transports: with PADDLE_ELASTIC_MASTER set, beats go to the
    launcher's membership registry (launch/master.py, no shared
    filesystem needed); otherwise the single-host fallback touches
    PADDLE_HEARTBEAT_DIR/hb_<rank>."""
    global _hb_thread
    master_ep = os.environ.get("PADDLE_ELASTIC_MASTER")
    hb_dir = os.environ.get("PADDLE_HEARTBEAT_DIR")
    if (not master_ep and not hb_dir) or _hb_thread is not None:
        return
    import threading
    import time

    rank = get_rank()
    client = None
    if master_ep:
        from .launch.master import MembershipClient

        client = MembershipClient(master_ep)
    # master mode is EXCLUSIVE: beats go only to the registry (the dir
    # protocol remains the standalone fallback)
    path = (os.path.join(hb_dir, f"hb_{rank}")
            if hb_dir and client is None else None)

    # a worker that exits CLEANLY must not look like a wedged one:
    # deregister / remove the beat so monitors stop tracking it
    import atexit

    def _tombstone():
        if client is not None:
            try:
                client.clear(rank)
            except OSError:
                pass
        if path:
            try:
                os.unlink(path)
            except OSError:
                pass

    atexit.register(_tombstone)

    from . import resilience

    def beat():
        while True:
            if client is not None:
                try:
                    # degraded-vs-dead: carry retry telemetry so the
                    # launcher can tell a retry-storming (but alive)
                    # rank from a wedged one (launch/master.py health)
                    n_recent = resilience.recent_failures(30.0)
                    client.beat(rank, degraded=n_recent > 0,
                                retries=n_recent)
                except OSError:
                    pass
            if path:
                try:
                    with open(path, "w") as f:
                        f.write(str(time.time()))
                except OSError:
                    pass
            time.sleep(1.0)

    _hb_thread = threading.Thread(target=beat, daemon=True)
    _hb_thread.start()


def _process_group():
    """torch.distributed when a process group is up, else None."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist
    return None


def get_rank(group=None):
    if group is not None:
        return group.rank
    dist = _process_group()
    if dist is not None:
        return dist.get_rank()
    return int(os.environ.get("PADDLE_TRAINER_ID", "0"))


def get_world_size(group=None):
    if group is not None:
        return group.nranks
    dist = _process_group()
    if dist is not None:
        return dist.get_world_size()
    return int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))


class ParallelEnv:
    """(reference: python/paddle/fluid/dygraph/parallel.py ParallelEnv)."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def local_rank(self):
        return int(os.environ.get("PADDLE_LOCAL_RANK", str(get_rank())))

    @property
    def dev_id(self):
        return self.local_rank

    @property
    def current_endpoint(self):
        eps = self.trainer_endpoints
        return eps[self.rank] if self.rank < len(eps) else ""

    @property
    def trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else []

    @property
    def nranks(self):
        return get_world_size()
