"""Distributed job launcher — ``python -m
paddle_tpu_torch.distributed.launch`` (counterpart of
paddle_tpu/distributed/launch; the same flags, env contract, log names
and exit codes).

The launcher's job:

  1. set the env contract (PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM /
     PADDLE_MASTER / ...) for each worker process (`_worker_env`),
  2. point every worker at one rendezvous: on one node the launcher
     hosts the ``torch.distributed.TCPStore`` itself, on a socket it
     binds to a port the kernel picks and names in PADDLE_MASTER, so
     the workers connect as clients and concurrent launches cannot race
     for a port (distributed/env.py). The launcher's own modules import
     no torch (nor does the package above them in its process), so it
     spawns the workers at once; the store, which needs torch, takes
     the socket over while they start,
  3. babysit the pod: stream logs, propagate the first failure (the
     rest are killed), restart (--max_restart), watch heartbeats and
     elastic joins (--elastic_level).

Workers call `paddle_tpu_torch.distributed.init_parallel_env()`, which
picks up the contract, joins the gloo process group over the store and
selects the rank's GPU, ``cuda:{local_rank % device_count}``: several
ranks on one card share it, each with its own CUDA context.

Workers start through `subprocess` (never fork after CUDA init), each
pod in one process group of its own: a failure, a timeout or a signal
to the launcher kills the whole tree, the workers' own children
included.
"""
import argparse
import os
import signal
import socket
import subprocess
import sys
import time

__all__ = ["launch", "parse_args"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.distributed.launch",
        description="Launch a distributed paddle_tpu_torch job.",
    )
    p.add_argument("--master", default=None,
                   help="rendezvous host:port (default: a store the "
                        "launcher hosts, on one node)")
    p.add_argument("--rank", type=int, default=0,
                   help="rank of this node (0..nnodes-1)")
    p.add_argument("--nnodes", type=int, default=1,
                   help="number of nodes in the job")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="worker processes on this node (several may "
                        "share one GPU)")
    p.add_argument("--log_dir", default="log", help="per-rank log directory")
    p.add_argument("--job_id", default="default", help="job id for log names")
    p.add_argument("--devices", default=None,
                   help="restrict visible devices (sets "
                        "CUDA_VISIBLE_DEVICES)")
    p.add_argument("--max_restart", type=int, default=0,
                   help="restart the pod up to N times on failure")
    p.add_argument("--elastic_level", type=int, default=0,
                   help="0: restart-only; >=1: elastic membership — "
                        "scale-IN (after 2 consecutive failed attempts, "
                        "re-form the pod over the surviving slots with "
                        "contiguous rank remap) AND scale-OUT (a "
                        "fleet.elastic.request_scale_out join request "
                        "tears the pod down and re-forms it with the "
                        "joiners admitted). Single-node pods only.")
    p.add_argument("--elastic_timeout", type=float, default=30.0,
                   help="seconds without a worker heartbeat before the "
                        "pod is declared hung and restarted")
    p.add_argument("--log_level", default="INFO")
    p.add_argument("training_script", help="script to run")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _worker_env(args, local_rank, master, nproc=None, mm_endpoint=None,
                attempt=0):
    nproc = nproc if nproc is not None else args.nproc_per_node
    world = args.nnodes * nproc
    rank = args.rank * nproc + local_rank
    env = dict(os.environ)
    env.update({
        "PADDLE_MASTER": master,
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(world),
        "PADDLE_LOCAL_RANK": str(local_rank),
        "PADDLE_LOCAL_SIZE": str(nproc),
        "PADDLE_NNODES": str(args.nnodes),
        "PADDLE_JOB_ID": args.job_id,
        "PADDLE_HEARTBEAT_DIR": os.path.join(args.log_dir, "hb"),
        "PADDLE_ELASTIC_TIMEOUT": str(args.elastic_timeout),
        # per-rank anomaly journal (resilience.py) lands next to the logs
        "PADDLE_LOG_DIR": args.log_dir,
        # pod incarnation: namespaces the store's keys so a restarted
        # pod can never collide with a previous incarnation's leftovers
        "PADDLE_POD_ATTEMPT": str(attempt),
    })
    if mm_endpoint:
        env["PADDLE_ELASTIC_MASTER"] = mm_endpoint
    if args.devices is not None:
        env["CUDA_VISIBLE_DEVICES"] = args.devices
    return env


def _spawn_pod(args, master, nproc=None, mm=None, attempt=0,
               hosted=False):
    """Start nproc workers in one new process group; local rank 0
    inherits the console. Returns [(Popen, log file or None)]."""
    nproc = nproc if nproc is not None else args.nproc_per_node
    os.makedirs(args.log_dir, exist_ok=True)
    hb_dir = os.path.join(args.log_dir, "hb")
    os.makedirs(hb_dir, exist_ok=True)
    # clear stale beats from a previous attempt. join_* requests are NOT
    # touched: they are consumed only by launch() after counting, so a
    # request landing during a teardown window is admitted next round
    # instead of silently dropped.
    if mm is not None:
        mm.reset_beats()
    for f in os.listdir(hb_dir):
        if f.startswith("hb_"):
            try:
                os.unlink(os.path.join(hb_dir, f))
            except OSError:
                pass
    procs = []
    cmd = [sys.executable, args.training_script] + args.training_script_args
    for lr in range(nproc):
        env = _worker_env(args, lr, master, nproc,
                          mm_endpoint=mm.endpoint if mm else None,
                          attempt=attempt)
        if hosted:
            env["PADDLE_MASTER_HOSTED"] = "1"
        rank = env["PADDLE_TRAINER_ID"]
        if lr == 0:
            out = None  # inherit
        else:
            # append so logs from failed attempts survive --max_restart
            out = open(os.path.join(
                args.log_dir, f"{args.job_id}.rank{rank}.log"), "a")
        pgid = procs[0][0].pid if procs else 0
        procs.append((subprocess.Popen(
            cmd, env=env, stdout=out,
            stderr=subprocess.STDOUT if out else None,
            process_group=pgid), out))
    return procs


RC_SCALE_OUT = 97  # synthetic: pod torn down to admit joining workers


def _pending_joins(hb_dir):
    """join_* request files dropped by elastic.request_scale_out (the
    heartbeat dir plays the membership registry). Shared protocol lives
    in launch/master.py."""
    from .master import pending_join_files

    return pending_join_files(hb_dir)


def _stale_beats(mm, hb_dir, hb_timeout):
    """(name, age) of workers whose heartbeat exceeds hb_timeout — from
    the membership master when one is active (cross-host, no shared
    FS), else from the heartbeat directory's file mtimes."""
    if mm is not None:
        return [(f"rank {r}", age) for r, age in mm.peers()
                if age > hb_timeout]
    out = []
    now = time.time()
    try:
        beats = os.listdir(hb_dir)
    except OSError:
        beats = []
    for f in beats:
        if not f.startswith("hb_"):
            continue  # join_* requests are not heartbeats
        try:
            age = now - os.path.getmtime(os.path.join(hb_dir, f))
        except OSError:
            continue
        if age > hb_timeout:
            out.append((f, age))
    return out


def _kill_pod(procs, grace_s=10.0):
    """SIGTERM the pod's process group, give it `grace_s`, then SIGKILL
    whatever is left of the group (the workers' own children too)."""
    pgid = procs[0][0].pid
    try:
        os.killpg(pgid, signal.SIGTERM)
    except (ProcessLookupError, PermissionError):
        pass
    deadline = time.time() + grace_s
    for p, _ in procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            pass
    try:
        os.killpg(pgid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass
    for p, _ in procs:
        p.wait()


def _wait_pod(procs, poll_s=0.2, hb_dir=None, hb_timeout=0.0,
              rank_base=0, watch_joins=False, mm=None):
    """Block until all exit ok or one fails (then kill the rest).

    A worker whose heartbeat goes stale for longer than hb_timeout is
    declared HUNG and fails the pod — liveness alone misses a worker
    wedged in a dead collective. Beats come from the membership master
    (`mm`, launch/master.py) or the heartbeat dir fallback. Only workers
    that have beaten at least once are monitored, so scripts that never
    call init_parallel_env are unaffected. With watch_joins, a pending
    join request tears the pod down with RC_SCALE_OUT so the caller can
    re-form it at the larger size. However the wait ends (a signal to
    the launcher included), the pod's process group is killed."""
    alive = {i: p for i, (p, _) in enumerate(procs)}
    failed_rc = 0
    degraded = set()   # ranks currently marked degraded (log transitions)
    try:
        while alive and not failed_rc:
            time.sleep(poll_s)
            if mm is not None:
                # degraded-vs-dead: a rank that beats but reports retry
                # storms is logged, not failed — only beat STALENESS
                # (below) kills the pod
                for r, h in mm.health().items():
                    if h["degraded"] and r not in degraded:
                        degraded.add(r)
                        print(f"[launch] worker rank {r} DEGRADED "
                              f"({h['retries']} recent retries; still "
                              "beating — not restarting)",
                              file=sys.stderr, flush=True)
                    elif not h["degraded"] and r in degraded:
                        degraded.discard(r)
                        print(f"[launch] worker rank {r} recovered "
                              "(retries subsided)",
                              file=sys.stderr, flush=True)
            if watch_joins and (
                    (mm is not None and mm.pending_joins())
                    or (hb_dir and _pending_joins(hb_dir))):
                failed_rc = RC_SCALE_OUT
                break
            for i, p in list(alive.items()):
                rc = p.poll()
                if rc is None:
                    continue
                del alive[i]
                if rc != 0:
                    failed_rc = rc
                    print(f"[launch] worker rank {rank_base + i} exited "
                          f"with {rc}; stopping the pod",
                          file=sys.stderr, flush=True)
                else:
                    # clean exit: drop the worker's beat so the
                    # staleness monitor doesn't mistake "finished" for
                    # "wedged"
                    if mm is not None:
                        mm.clear_rank(rank_base + i)
                    if hb_dir:
                        try:
                            os.unlink(os.path.join(hb_dir,
                                                   f"hb_{rank_base + i}"))
                        except OSError:
                            pass
            if not failed_rc and hb_timeout > 0 and (mm is not None
                                                     or hb_dir):
                for name, age in _stale_beats(mm, hb_dir, hb_timeout):
                    print(f"[launch] worker {name} heartbeat stale "
                          f"({age:.0f}s > {hb_timeout:.0f}s): pod hung",
                          file=sys.stderr, flush=True)
                    failed_rc = 98  # synthetic "hung" exit code
                    break
    finally:
        _kill_pod(procs, grace_s=10.0 if alive else 0.0)
        for _, out in procs:
            if out:
                out.close()
    return failed_rc


def _host_store(listener):
    """The rendezvous store over the launcher's listening socket. Its
    torch import runs while the workers start: a worker that connects
    first waits in the socket's backlog."""
    import torch.distributed as dist

    port = listener.getsockname()[1]
    return dist.TCPStore("127.0.0.1", port, None, True,
                         wait_for_workers=False,
                         master_listen_fd=listener.detach())


def _exit_on_signal(signum, frame):
    # unwinds through _wait_pod's finally, which kills the pod
    sys.exit(128 + signum)


def launch(argv=None):
    args = parse_args(argv)
    # the launcher is a supervisor, not the measured workload: under
    # PT_TELEMETRY=1 its own at-exit export would land on rank 0's
    # files (no PADDLE_TRAINER_ID here) and overwrite the worker's real
    # snapshot after the pod exits — drop to counting-only
    from ...observability import full_enabled, set_mode

    if full_enabled():
        set_mode("metrics")
    if args.training_script_args[:1] == ["--"]:
        args.training_script_args = args.training_script_args[1:]
    for sig in (signal.SIGTERM, signal.SIGHUP):
        signal.signal(sig, _exit_on_signal)
    master = args.master
    listener = store = None
    if master is None:
        if args.nnodes > 1:
            sys.exit("--master is required when --nnodes > 1")
        # the launcher hosts the rendezvous on a port the kernel picks
        # (no window between choosing a port and binding it); the store
        # takes the listening socket over once the pod is spawned
        listener = socket.create_server(("127.0.0.1", 0))
        master = f"127.0.0.1:{listener.getsockname()[1]}"
    if args.elastic_level >= 1 and args.nnodes > 1:
        # membership (heartbeats/joins) is cross-host via the
        # MembershipMaster, but pod RE-FORMING at a new size is still
        # coordinated per launcher invocation
        sys.exit("--elastic_level>=1 is single-node-pod scoped "
                 "(cross-host membership is available via "
                 "PADDLE_ELASTIC_MASTER, but pod re-forming is not "
                 "multi-node yet)")
    nproc = args.nproc_per_node
    hb_dir = os.path.join(args.log_dir, "hb")
    # Cross-host membership registry: beats and join requests flow
    # through it, so elastic monitoring needs no shared filesystem.
    # PADDLE_TPU_MEMBERSHIP=dir forces the heartbeat-directory protocol.
    from .master import MembershipMaster

    mm = (None if os.environ.get("PADDLE_TPU_MEMBERSHIP") == "dir"
          else MembershipMaster(
              route_via=master if args.nnodes > 1 else None))
    # join requests are only meaningful within ONE launch invocation —
    # a leftover from a previous job must not instantly tear down this
    # pod
    for path in _pending_joins(hb_dir):
        try:
            os.unlink(path)
        except OSError:
            pass
    consecutive = 0
    attempt = 0
    # pod incarnation counter: bumped on EVERY re-form (failure restart,
    # scale-in, scale-out) — unlike `attempt`, which only counts failures
    # toward --max_restart. It feeds PADDLE_POD_ATTEMPT, the epoch that
    # namespaces the store's keys.
    pod_gen = -1
    rc = 1
    while True:
        pod_gen += 1
        procs = _spawn_pod(args, master, nproc, mm=mm, attempt=pod_gen,
                           hosted=listener is not None)
        if listener is not None and store is None:
            try:
                store = _host_store(listener)
            except BaseException:
                _kill_pod(procs)
                raise
        rc = _wait_pod(procs, hb_dir=hb_dir,
                       hb_timeout=args.elastic_timeout
                       if args.elastic_timeout > 0 else 0.0,
                       rank_base=args.rank * nproc,
                       watch_joins=args.elastic_level >= 1, mm=mm)
        if rc == 0:
            return 0
        n_joins = 0
        if args.elastic_level >= 1:
            join_files = _pending_joins(hb_dir)
            n_joins = len(join_files)
            if mm is not None:
                n_joins += mm.pending_joins()
        if rc == RC_SCALE_OUT and n_joins:
            # node join: admit the joiners, re-form the pod at the larger
            # size with contiguous ranks. Not a failure: does not consume
            # --max_restart. Consume EXACTLY the counted requests — one
            # that lands between the count and the respawn survives for
            # the next watch round.
            for path in join_files:
                try:
                    os.unlink(path)
                except OSError:
                    pass
            if mm is not None:
                mm.consume_joins(n_joins - len(join_files))
            nproc += n_joins
            consecutive = 0
            print(f"[launch] elastic scale-out: {n_joins} "
                  f"worker(s) joining; re-forming pod with {nproc} "
                  f"workers (ranks remapped 0..{nproc - 1})",
                  file=sys.stderr, flush=True)
            continue
        # a worker that genuinely exits 97 (without any join request)
        # falls through to the normal failure/restart path
        attempt += 1
        if attempt > args.max_restart:
            break
        print(f"[launch] pod failed; restart {attempt}/{args.max_restart}"
              f" (nproc={nproc})", file=sys.stderr, flush=True)
        consecutive += 1
        # elastic scale-in: the pod keeps dying at this size — re-form it
        # over the surviving slots with a contiguous rank remap
        if args.elastic_level >= 1 and consecutive >= 2 and nproc > 1:
            nproc -= 1
            consecutive = 0
            print(f"[launch] elastic scale-in: re-forming pod with "
                  f"{nproc} workers (ranks remapped 0..{nproc - 1})",
                  file=sys.stderr, flush=True)
    sys.exit(rc)
