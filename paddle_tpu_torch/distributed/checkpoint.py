"""Sharded, asynchronous, atomic checkpointing (counterpart of
paddle_tpu/distributed/checkpoint.py; the same on-disk format, byte for
byte, so a checkpoint written by either package loads in the other).

- **Each rank writes what it owns.** A plain tensor is replicated: rank
  0 writes it. A :class:`LocalShard` (a rank's block of a global array,
  as the ZeRO train step keeps optimizer moments and, at ``p_g_os``,
  parameters) is written by its rank, with its `index` ranges. Loading
  reassembles any shard layout, so a checkpoint taken at one data
  parallel width restores at another.
- **Async by construction.** A save is two phases. The SNAPSHOT phase
  runs on the step path: every saved tensor is copied into an owned host
  buffer (from the card: a pinned staging buffer, the copies queued on
  the current stream behind the step that produced the tensors, one
  event recorded after them), plus all cross-rank coordination — so the
  step may overwrite every saved tensor the moment it returns. The
  COMMIT phase (wait for the event, durable write, fsync, atomic rename)
  runs on a background thread with `async_save=True` and issues no
  collectives: cross-rank completion is coordinated through per-rank
  ``DONE.<rank>`` marker files in the tmp dir. A save issued while a
  commit is in flight back-pressures (joins it, journaled
  ``ckpt_backpressure``, counted into ``pt_ckpt_step_stall_seconds``).
- **Atomic commit.** Everything is written into ``<dir>.tmp``; each rank
  drops its ``DONE.<rank>`` marker only after its shards and meta
  fragment are durable, and the rename into place happens exactly once
  (leader elected by ``COMMIT_LEADER`` O_EXCL) only after every rank's
  marker is present. `is_complete` re-verifies the marker set against
  the ``commit.world`` recorded in meta.json.

Layout::

    ckpt-000042/
      meta.json            # commit record: leaf table + commit.world
      DONE.<r>             # per-rank commit markers
      shards/<leaf>#r<rank>s<k>.npy

A bf16 (or fp8) leaf is stored as the unsigned integer of its width
under its logical dtype name; the port reads and writes that storage
through `torch.Tensor.view`, never through `ml_dtypes`. Multi-process
jobs: each process writes its shard files plus a ``meta.rank<r>.json``
fragment into the shared checkpoint directory; the elected leader merges
the fragments and renames. Chaos scopes ``ckpt.snapshot`` /
``ckpt.commit`` / ``ckpt.commit.<rank>`` / ``ckpt.kill_window`` target
the phases deterministically.
"""
import hashlib
import json
import os
import shutil
import threading
import time as _time

import numpy as np
import torch

from ..observability import metrics as _obs
from ..observability import steptrace as _steptrace
from ..observability.tracing import trace_span as _trace_span
from . import chaos
from .resilience import RetryPolicy, record

# telemetry: durations, bytes moved, and the torn-checkpoint fallbacks
# that tell an operator a filesystem is eating commits
_SAVE_SECONDS = _obs.histogram("pt_ckpt_save_seconds",
                               "save_state_dict wall time")
_LOAD_SECONDS = _obs.histogram("pt_ckpt_load_seconds",
                               "load_state_dict wall time")
_BYTES_TOTAL = _obs.counter("pt_ckpt_bytes_total",
                            "checkpoint bytes, by direction",
                            labelnames=("direction",))
_OPS_TOTAL = _obs.counter("pt_ckpt_ops_total",
                          "completed checkpoint operations",
                          labelnames=("op",))
_TORN_FALLBACKS = _obs.counter(
    "pt_ckpt_torn_fallbacks_total",
    "torn checkpoints skipped by load_latest's older-checkpoint "
    "fallback")
_STALL_SECONDS = _obs.histogram(
    "pt_ckpt_step_stall_seconds",
    "time the training step path actually blocked on a save "
    "(back-pressure + snapshot phase; the commit runs off the step "
    "path under async_save)")
_COMMIT_SECONDS = _obs.histogram(
    "pt_ckpt_commit_seconds",
    "background COMMIT phase wall time (durable shard write -> rename "
    "visible)")
_INFLIGHT = _obs.gauge(
    "pt_ckpt_inflight", "checkpoint commits currently in flight")
_INCOMPLETE_DISCARDED = _obs.counter(
    "pt_ckpt_incomplete_discarded_total",
    "checkpoint dirs rejected because a rank's DONE commit marker is "
    "missing (counted once per directory per process)")

__all__ = ["save_state_dict", "load_state_dict", "Checkpointer",
           "verify_integrity", "is_complete", "TornCheckpointError",
           "LocalShard"]


class TornCheckpointError(ValueError):
    """A checkpoint failed its meta.json integrity check (truncated or
    missing shards behind a committed meta). Distinct from the plain
    ValueError a model/optimizer structure mismatch raises, so
    load_latest's older-checkpoint fallback can never swallow the
    latter and silently restart a run from step 0."""


class LocalShard:
    """This rank's block of a global array: `tensor` holds the elements
    `index` (one [start, stop) pair per dimension) of an array of
    `global_shape`. `write=False` marks a replica of a block another rank
    writes (a save lists the leaf but writes no file for it)."""

    def __init__(self, tensor, global_shape, index, write=True):
        self.tensor = tensor
        self.global_shape = tuple(int(d) for d in global_shape)
        self.index = [[int(a), int(b)] for a, b in index]
        self.write = bool(write)

    def __repr__(self):
        return (f"LocalShard({tuple(self.tensor.shape)} of "
                f"{self.global_shape} at {self.index})")


_META = "meta.json"

# two-phase commit protocol files (inside <path>.tmp): per-rank DONE
# markers + the leader-election lock for the final rename
_DONE_PREFIX = "DONE."
_LEADER = "COMMIT_LEADER"
# commit-phase marker-wait budget: bounded so a rank SIGKILLed before
# its marker can never wedge a surviving writer thread forever
_COMMIT_TIMEOUT_S = float(os.environ.get("PT_CKPT_COMMIT_TIMEOUT_S",
                                         "600"))
_POLL_S = 0.01

# Durability: fsync shard files, meta.json and the directories before the
# .tmp rename. PT_CKPT_FSYNC=0 opts out (e.g. throwaway tmpfs test runs).
_FSYNC = os.environ.get("PT_CKPT_FSYNC", "1") != "0"


def _fsync_dir(path):
    if not _FSYNC:
        return
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


# ---------------------------------------------------------------- flatten

class _Sentinel:
    def __init__(self, tag):
        self.tag = tag


_EMPTY_DICT = _Sentinel("__empty_dict__")
_EMPTY_LIST = _Sentinel("__empty_list__")


def _is_leaf(obj):
    return isinstance(obj, (torch.Tensor, np.ndarray, LocalShard, str,
                            bytes, int, float, bool, type(None)))


def _flatten(obj, path=(), list_paths=None):
    """Nested dict/list → [(path_tuple, leaf)]. `list_paths` (a set,
    when given) records paths of list/tuple nodes so load can restore
    them as lists."""
    if isinstance(obj, dict):
        if not obj:
            return [(path, _EMPTY_DICT)]
        out = []
        for k, v in obj.items():
            out += _flatten(v, path + (str(k),), list_paths)
        return out
    if isinstance(obj, (list, tuple)) and not _is_leaf(obj):
        if list_paths is not None:
            list_paths.add("/".join(path))
        if not obj:
            return [(path, _EMPTY_LIST)]
        out = []
        for i, v in enumerate(obj):
            out += _flatten(v, path + (str(i),), list_paths)
        return out
    return [(path, obj)]


def _leaf_name(path):
    tail = "_".join(path[-2:]) if path else "leaf"
    safe = "".join(c if c.isalnum() or c in "._-" else "-" for c in tail)
    return f"{safe}.{hashlib.sha1('/'.join(path).encode()).hexdigest()[:10]}"


def _nest(flat, list_paths=()):
    """[(path, value)] → nested dicts; nodes recorded in `list_paths`
    come back as lists ordered by integer key."""
    root = {}
    for path, v in flat:
        d = root
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v

    def _relist(node, path):
        if not isinstance(node, dict):
            return node
        out = {k: _relist(v, path + (k,)) for k, v in node.items()}
        if "/".join(path) in list_paths:
            return [out[k] for k in sorted(out, key=int)]
        return out

    return _relist(root, ())


# ------------------------------------------------------ dtypes and storage

# torch dtypes numpy lacks: stored as the unsigned integer of their width
# under the logical name the reference's ml_dtypes gives them
_LOGICAL = {torch.bfloat16: "bfloat16"}
for _name in ("float8_e4m3fn", "float8_e5m2"):
    if hasattr(torch, _name):
        _LOGICAL[getattr(torch, _name)] = _name
_TORCH_OF = {v: k for k, v in _LOGICAL.items()}
# the signed integer a same-width storage goes through (torch.from_numpy
# takes no uint16 / uint32 on every version)
_SIGNED_OF_SIZE = {1: (np.int8, torch.int8), 2: (np.int16, torch.int16)}
_UNSIGNED_OF_SIZE = {1: np.uint8, 2: np.uint16}


def _logical_dtype(t):
    if isinstance(t, np.ndarray):
        return str(t.dtype)
    if t.dtype in _LOGICAL:
        return _LOGICAL[t.dtype]
    return str(torch.empty((), dtype=t.dtype).numpy().dtype)


def _to_storage(host):
    """(storage ndarray, logical dtype name) of an owned host tensor or
    ndarray: bf16 / fp8 as the unsigned integer of their width."""
    if isinstance(host, np.ndarray):
        return host, str(host.dtype)
    if host.dtype in _LOGICAL:
        size = host.element_size()
        sig = _SIGNED_OF_SIZE[size][1]
        arr = host.view(sig).numpy().view(_UNSIGNED_OF_SIZE[size])
        return arr, _LOGICAL[host.dtype]
    arr = host.numpy()
    return arr, str(arr.dtype)


def _from_storage(nparr, logical_dtype):
    """A CPU tensor of `logical_dtype` over the stored array (a bf16 /
    fp8 leaf: its integer storage viewed as that dtype)."""
    # (np.ascontiguousarray would turn a 0-d array into a 1-d one)
    nparr = np.require(nparr, requirements="C")
    if logical_dtype in _TORCH_OF:
        np_sig, _ = _SIGNED_OF_SIZE[nparr.dtype.itemsize]
        return torch.from_numpy(nparr.view(np_sig)).view(
            _TORCH_OF[logical_dtype])
    if str(nparr.dtype) != logical_dtype:
        nparr = nparr.view(np.dtype(logical_dtype))
    return torch.from_numpy(nparr)


# ------------------------------------------------------------------- save

def _proc_index():
    from . import xproc

    if xproc.is_multiprocess():
        from . import env

        return env.get_rank(), env.get_world_size()
    return 0, 1


# back-pressure: commits in flight in this process. A new save joins
# them before snapshotting (unbounded pile-up under a slow filesystem
# would eat host RAM one full host-snapshot per lap) — the join time is
# step-path stall and is counted into pt_ckpt_step_stall_seconds.
_inflight_lock = threading.Lock()
_inflight = []


def _join_inflight():
    with _inflight_lock:
        handles = [h for h in _inflight if h.is_alive()]
    for h in handles:
        h.join()
    return bool(handles)


def _stage(t):
    """An owned host copy of tensor `t`: from the card, a pinned buffer
    filled by a copy queued on the current stream; on the CPU, a clone
    (the step updates its tensors in place)."""
    t = t.detach()
    if t.device.type == "cuda":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host
    return t.clone()


def save_state_dict(state, path, async_save=False, _stall_start=None):
    """Write `state` (nested dict of tensors / ndarrays / LocalShards /
    scalars) to directory `path`. Every process saves only what it owns.

    The SNAPSHOT phase (everything up to the returned handle: the host
    copies queued, cross-rank barriers) is synchronous — after it, the
    caller may overwrite every saved tensor on the current stream. With
    async_save=True the COMMIT phase (durable write + marker protocol +
    rename) runs on a background thread and issues no collectives.
    Returns a handle with .result() (joins the committer; re-raises
    errors); with async_save=False the checkpoint is complete and
    visible on return."""
    t_stall0 = _time.perf_counter() if _stall_start is None \
        else _stall_start
    if _join_inflight():
        record("ckpt_backpressure", path=path)
    rank, nproc = _proc_index()
    tmp = path + ".tmp"
    if rank == 0:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(os.path.join(tmp, "shards"), exist_ok=True)
    if nproc > 1:
        from . import xproc

        xproc.barrier()  # tmp dir exists before anyone writes
        os.makedirs(os.path.join(tmp, "shards"), exist_ok=True)

    leaves, scalars, pending = [], {}, []
    list_paths, bytes_paths = set(), []
    empties = {}
    on_card = False
    for p, leaf in _flatten(state, list_paths=list_paths):
        if any("/" in comp for comp in p):
            raise ValueError(
                f"state dict key {p!r} contains '/', which is the path "
                "separator — rename the key")
        key = "/".join(p)
        if isinstance(leaf, _Sentinel):
            empties[key] = leaf.tag
            continue
        if isinstance(leaf, np.generic):  # numpy scalar → python scalar
            leaf = leaf.item()
        if isinstance(leaf, (torch.Tensor, np.ndarray, LocalShard)):
            if isinstance(leaf, LocalShard):
                data, shape, idx = leaf.tensor, leaf.global_shape, \
                    leaf.index
                owner = leaf.write
            else:
                data, shape = leaf, tuple(leaf.shape)
                idx = [[0, int(d)] for d in shape]
                owner = rank == 0   # replicated: one copy, rank 0's
            entry = {"path": key, "shape": [int(d) for d in shape],
                     "dtype": _logical_dtype(data), "shards": []}
            if owner:
                fname = f"{_leaf_name(p)}#r{rank}s0.npy"
                entry["shards"].append({"index": idx, "file": fname})
                if isinstance(data, np.ndarray):
                    host = np.array(data, copy=True)
                else:
                    on_card |= data.device.type == "cuda"
                    host = _stage(data)
                pending.append((os.path.join(tmp, "shards", fname), host))
            leaves.append(entry)
        else:
            if isinstance(leaf, bytes):
                bytes_paths.append(key)
                leaf = leaf.decode("latin1")
            scalars[key] = leaf

    # the device → host copies are queued; the commit waits for this
    # event before it reads the staging buffers
    ready = None
    if on_card:
        ready = torch.cuda.Event()
        ready.record()
    # scope contract (chaos.py table): fires AFTER the host copies are
    # taken, BEFORE the commit hand-off
    chaos.fire("ckpt.snapshot")
    if nproc > 1:
        from . import xproc

        # every rank snapshotted — the LAST collective of this save;
        # the commit phase coordinates through marker files only
        xproc.barrier()

    committer = _Committer(
        tmp=tmp, path=path, rank=rank, nproc=nproc, pending=pending,
        leaves=leaves, scalars=scalars, lists=sorted(list_paths),
        bytes_paths=bytes_paths, empties=empties, t_start=t_stall0,
        ready=ready)
    if async_save:
        h = _AsyncHandle(committer.run)
        h.committer = committer
        with _inflight_lock:
            _inflight.append(h)
        h.start()
        _STALL_SECONDS.observe(_time.perf_counter() - t_stall0)
        return h
    committer.run()
    # synchronous saves stall the step path for the whole commit;
    # observed on success only (a retried save re-enters with the
    # original _stall_start)
    _STALL_SECONDS.observe(_time.perf_counter() - t_stall0)
    h = _DoneHandle()
    h.committer = committer
    return h


class _Committer:
    """The background COMMIT phase of one save: durable shard writes,
    the per-rank DONE marker protocol, and the leader-elected atomic
    rename. INVARIANT: no collectives and no store traffic here — a
    commit-thread collective would interleave with whatever the main
    thread issues meanwhile. Cross-rank coordination is marker files on
    the shared checkpoint filesystem only."""

    def __init__(self, tmp, path, rank, nproc, pending, leaves, scalars,
                 lists, bytes_paths, empties, t_start, ready=None):
        self.tmp = tmp
        self.path = path
        self.rank = rank
        self.nproc = nproc
        self.pending = pending
        self.leaves = leaves
        self.scalars = scalars
        self.lists = lists
        self.bytes_paths = bytes_paths
        self.empties = empties
        self.t_start = t_start
        self.ready = ready
        self.seconds = None     # this commit's wall time, once run
        self.bytes = None       # the bytes this rank wrote, once run

    def run(self):
        t0 = _time.perf_counter()
        _INFLIGHT.inc()
        try:
            with _trace_span("ckpt.save", path=self.path):
                self._commit_phase()
            _OPS_TOTAL.labels(op="save").inc()
            _SAVE_SECONDS.observe(_time.perf_counter() - self.t_start)
        finally:
            _INFLIGHT.dec()
            self.seconds = _time.perf_counter() - t0
            _COMMIT_SECONDS.observe(self.seconds)

    def _commit_phase(self):
        chaos.fire("ckpt.commit")
        chaos.fire(f"ckpt.commit.{self.rank}")
        if self.ready is not None:
            self.ready.synchronize()
        n_bytes = 0
        for fpath, host in self.pending:
            storage, _ = _to_storage(host)
            n_bytes += storage.nbytes
            with open(fpath, "wb") as f:
                np.save(f, storage)
                if _FSYNC:
                    f.flush()
                    os.fsync(f.fileno())
        self.pending = []       # the host copies are on disk: free them
        if self.nproc > 1:
            frag = {"leaves": self.leaves, "scalars": self.scalars,
                    "lists": self.lists, "bytes": self.bytes_paths,
                    "empties": self.empties}
            with open(os.path.join(self.tmp,
                                   f"meta.rank{self.rank}.json"),
                      "w") as f:
                json.dump(frag, f)
                if _FSYNC:
                    f.flush()
                    os.fsync(f.fileno())
        # THE torn-commit window: this rank's shards are on disk, its
        # commit marker is not
        chaos.fire("ckpt.kill_window")
        marker = os.path.join(self.tmp, f"{_DONE_PREFIX}{self.rank}")
        with open(marker, "w") as f:
            f.write(str(_time.time()))
            if _FSYNC:
                f.flush()
                os.fsync(f.fileno())
        _fsync_dir(os.path.join(self.tmp, "shards"))
        _fsync_dir(self.tmp)
        self._await_markers()
        if self._claim_leader():
            self._finalize()
        self._await_visible()
        self.bytes = n_bytes
        _BYTES_TOTAL.labels(direction="saved").inc(n_bytes)

    def _deadline(self):
        return _time.monotonic() + _COMMIT_TIMEOUT_S

    def _visible(self):
        """The rename happened: tmp is gone."""
        return not os.path.isdir(self.tmp)

    def _await_markers(self):
        deadline = self._deadline()
        while True:
            if self._visible():
                return
            if all(os.path.exists(
                    os.path.join(self.tmp, f"{_DONE_PREFIX}{r}"))
                    for r in range(self.nproc)):
                return
            if _time.monotonic() > deadline:
                record("ckpt_commit_timeout", path=self.path,
                       phase="markers", rank=self.rank)
                raise TimeoutError(
                    f"ckpt commit {self.path}: not every rank's "
                    f"{_DONE_PREFIX}<r> marker appeared within "
                    f"{_COMMIT_TIMEOUT_S:.0f}s — a peer likely died "
                    "mid-commit; this checkpoint stays invisible and "
                    "load_latest falls back to the previous one")
            _time.sleep(_POLL_S)

    def _claim_leader(self):
        """Exactly-once rename election: O_CREAT|O_EXCL on the shared
        lock file, claimed only after every marker is present."""
        try:
            fd = os.open(os.path.join(self.tmp, _LEADER),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        except FileNotFoundError:
            return False        # a peer already renamed tmp away
        os.close(fd)
        return True

    def _finalize(self):
        if self.nproc > 1:
            seen_scalars, by_path, empt = {}, {}, {}
            lists, byts = set(), set()
            for r in range(self.nproc):
                with open(os.path.join(
                        self.tmp, f"meta.rank{r}.json")) as f:
                    fr = json.load(f)
                seen_scalars.update(fr["scalars"])
                lists.update(fr["lists"])
                byts.update(fr["bytes"])
                empt.update(fr.get("empties", {}))
                for e in fr["leaves"]:
                    tgt = by_path.setdefault(e["path"], e)
                    if tgt is not e:
                        tgt["shards"] += e["shards"]
            _commit(self.tmp, self.path, list(by_path.values()),
                    seen_scalars, sorted(lists), sorted(byts), empt,
                    world=self.nproc)
        else:
            _commit(self.tmp, self.path, self.leaves, self.scalars,
                    self.lists, self.bytes_paths, self.empties,
                    world=1)

    def _await_visible(self):
        deadline = self._deadline()
        while not self._visible():
            if _time.monotonic() > deadline:
                record("ckpt_commit_timeout", path=self.path,
                       phase="rename", rank=self.rank)
                raise TimeoutError(
                    f"ckpt commit {self.path}: the elected leader never "
                    f"published the rename within "
                    f"{_COMMIT_TIMEOUT_S:.0f}s")
            _time.sleep(_POLL_S)


def _commit(tmp, path, leaves, scalars, list_paths=(), bytes_paths=(),
            empties=None, world=1):
    # integrity record: leaf count + per-shard byte size, so load can
    # reject a torn checkpoint; `commit.world` records how many DONE.<r>
    # markers is_complete must re-verify
    shard_sizes = {}
    for e in leaves:
        for srec in e["shards"]:
            shard_sizes[srec["file"]] = os.path.getsize(
                os.path.join(tmp, "shards", srec["file"]))
    with open(os.path.join(tmp, _META), "w") as f:
        json.dump({"leaves": leaves, "scalars": scalars,
                   "lists": list(list_paths),
                   "bytes": list(bytes_paths),
                   "empties": empties or {},
                   "commit": {"world": int(world)},
                   "integrity": {"leaf_count": len(leaves),
                                 "shards": shard_sizes}}, f)
        if _FSYNC:
            f.flush()
            os.fsync(f.fileno())
    _fsync_dir(os.path.join(tmp, "shards"))
    _fsync_dir(tmp)
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))


def verify_integrity(path):
    """Validate a checkpoint directory against its meta.json integrity
    record (leaf count + per-shard byte sizes). Raises
    TornCheckpointError on a torn checkpoint; checkpoints written before
    the integrity record pass. Returns the parsed meta."""
    try:
        with open(os.path.join(path, _META)) as f:
            meta = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise TornCheckpointError(
            f"torn checkpoint {path}: unreadable {_META}: {e}") from e
    integ = meta.get("integrity")
    if integ is None:
        return meta
    if len(meta["leaves"]) != integ["leaf_count"]:
        raise TornCheckpointError(
            f"torn checkpoint {path}: meta lists {len(meta['leaves'])} "
            f"leaves, integrity record expects {integ['leaf_count']}")
    sizes = integ["shards"]
    for e in meta["leaves"]:
        for srec in e["shards"]:
            fname = srec["file"]
            if fname not in sizes:
                raise TornCheckpointError(
                    f"torn checkpoint {path}: shard {fname} missing "
                    "from integrity record")
            fpath = os.path.join(path, "shards", fname)
            try:
                actual = os.path.getsize(fpath)
            except OSError:
                raise TornCheckpointError(
                    f"torn checkpoint {path}: shard {fname} missing")
            if actual != sizes[fname]:
                raise TornCheckpointError(
                    f"torn checkpoint {path}: shard {fname} is {actual} "
                    f"bytes, committed as {sizes[fname]}")
    return meta


class _AsyncHandle(threading.Thread):
    def __init__(self, fn):
        super().__init__(daemon=True)
        self._fn = fn
        self._err = None

    def run(self):
        try:
            self._fn()
        except BaseException as e:  # surfaced in result()
            self._err = e
        finally:
            with _inflight_lock:
                try:
                    _inflight.remove(self)
                except ValueError:
                    pass

    def result(self):
        self.join()
        if self._err is not None:
            raise self._err


class _DoneHandle:
    def result(self):
        return None


# ------------------------------------------------------------------- load

# incomplete dirs counted once per path per process; completeness
# verdicts cached the same way (a published checkpoint dir is immutable)
_incomplete_seen_lock = threading.Lock()
_incomplete_seen = set()
_complete_seen = set()


def is_complete(path):
    """A committed checkpoint: meta.json present AND every rank's
    DONE.<r> commit marker (per meta's commit.world) present. A missing
    marker makes the directory invisible
    (pt_ckpt_incomplete_discarded_total); an unreadable meta.json is
    left for verify_integrity to classify as torn."""
    meta_p = os.path.join(path, _META)
    if not os.path.isfile(meta_p):
        return False
    with _incomplete_seen_lock:
        if path in _complete_seen:
            return True
    try:
        with open(meta_p) as f:
            world = int((json.load(f).get("commit") or {})
                        .get("world", 0))
    except (json.JSONDecodeError, UnicodeDecodeError, OSError,
            TypeError, ValueError):
        return True    # torn meta: load_latest's fallback handles it
    missing = [r for r in range(world)
               if not os.path.isfile(
                   os.path.join(path, f"{_DONE_PREFIX}{r}"))]
    if not missing:
        with _incomplete_seen_lock:
            _complete_seen.add(path)
        return True
    with _incomplete_seen_lock:
        if path not in _incomplete_seen:
            _incomplete_seen.add(path)
            _INCOMPLETE_DISCARDED.inc()
            record("ckpt_incomplete", path=path, missing_ranks=missing)
    return False


def load_state_dict(path, shardings=None, return_numpy=False):
    """Load a checkpoint directory into a nested dict. Array leaves come
    back as CPU tensors (numpy with return_numpy=True: a bf16 / fp8 leaf
    as float32, which holds it exactly). `shardings` maps a leaf path
    ("a/b/c") to the region this caller needs (a tuple of slices, one
    per dimension): only that region is read, from memory-mapped shard
    files, whatever shard layout wrote it.

    The meta.json integrity record is verified first: a torn checkpoint
    raises TornCheckpointError, never half-loads."""
    t_start = _time.perf_counter()
    meta = verify_integrity(path)
    flat = []
    for e in meta["leaves"]:
        shape = tuple(e["shape"])
        dtype = e["dtype"]
        mmaps = []
        for srec in e["shards"]:
            m = np.load(os.path.join(path, "shards", srec["file"]),
                        mmap_mode="r")
            mmaps.append((tuple((a, b) for a, b in srec["index"]), m))
        key = e["path"]
        region = (shardings or {}).get(key)
        if region is None:
            region = tuple(slice(0, d) for d in shape)
        starts = [s.start or 0 for s in region]
        stops = [s.stop if s.stop is not None else d
                 for s, d in zip(region, shape)]
        out = np.empty([b - a for a, b in zip(starts, stops)],
                       dtype=mmaps[0][1].dtype if mmaps else np.float32)
        for bounds, m in mmaps:
            inter = [(max(a, s), min(b, t))
                     for (a, b), s, t in zip(bounds, starts, stops)]
            if any(lo >= hi for lo, hi in inter):
                continue
            src = tuple(slice(lo - a, hi - a)
                        for (a, _), (lo, hi) in zip(bounds, inter))
            dst = tuple(slice(lo - s, hi - s)
                        for s, (lo, hi) in zip(starts, inter))
            out[dst] = m[src]
        t = _from_storage(out, dtype)
        if return_numpy:
            t = (t.float() if t.dtype in _LOGICAL else t).numpy()
        flat.append((tuple(key.split("/")), t))
    byts = set(meta.get("bytes", ()))
    for key, v in meta["scalars"].items():
        if key in byts:
            v = v.encode("latin1")
        flat.append((tuple(key.split("/")), v))
    for key, tag in meta.get("empties", {}).items():
        flat.append((tuple(key.split("/")),
                     {} if tag == "__empty_dict__" else []))
    out = _nest(flat, set(meta.get("lists", ())))
    integ = meta.get("integrity") or {}
    _BYTES_TOTAL.labels(direction="loaded").inc(
        sum(integ.get("shards", {}).values()))
    _OPS_TOTAL.labels(op="load").inc()
    _LOAD_SECONDS.observe(_time.perf_counter() - t_start)
    return out


# ----------------------------------------------------------- Checkpointer

def _model_state(model):
    """{name: tensor}: the parameters and named buffers, under the
    reference's state_dict keys (convert.py's naming)."""
    return {**dict(model.named_parameters()), **dict(model.named_buffers())}


class Checkpointer:
    """Train-loop checkpoint manager.

    save(step) captures the model's parameters and buffers, the
    optimizer's step count and LR-scheduler state, and — through a train
    step (`jit.TrainStep`, `DistributedTrainStep`) — its optimizer
    accumulators under ``train_step_opt/<param>/<acc>`` (without one,
    the eager optimizer's accumulators under ``optimizer``); keeps the
    newest `keep` checkpoints; `async_save` overlaps file writes with
    training. load_latest() restores everything and returns the step (or
    None if no complete checkpoint exists)."""

    def __init__(self, root, model=None, optimizer=None, train_step=None,
                 keep=3, async_save=False, retry=None):
        self.root = root
        self.model = model
        self.train_step = train_step
        self.optimizer = optimizer or (
            train_step.optimizer if train_step is not None else None)
        self.keep = keep
        self.async_save = async_save
        self._last = None
        # the last save's numbers: snapshot seconds on the step path,
        # commit seconds (None until committed) and bytes
        self.last_stats = {}
        # transient-FS hardening: loads are always retried; saves only
        # single-process + synchronous, where re-running is idempotent.
        # give_up_on FileNotFoundError: a missing shard behind a
        # committed meta is a TORN checkpoint, never a transient
        self.retry = retry or RetryPolicy(
            max_attempts=3, base_s=0.2, max_backoff_s=2.0,
            retry_on=(OSError,), give_up_on=(FileNotFoundError,),
            name="ckpt.io")

    def _dir(self, step):
        return os.path.join(self.root, f"ckpt-{step:08d}")

    def _name_maps(self):
        """optimizer name ↔ structural-key maps (the optimizer names a
        parameter as it was given: `model.parameters()` gives
        ``param_<i>``); checkpoints are keyed by the structural key."""
        by_pname, by_struct = {}, {}
        if self.model is not None and self.optimizer is not None:
            names = getattr(self.optimizer, "_names", {})
            for sname, p in self.model.named_parameters():
                pname = names.get(id(p))
                if pname is not None:
                    by_pname[pname] = sname
                    by_struct[sname] = pname
        return by_pname, by_struct

    @staticmethod
    def _remap_opt_keys(sd, mapping):
        """optimizer.state_dict keys look like f'{name}_{acc}'; rewrite
        the name prefix via mapping (longest-prefix match). Non-param
        keys (@step, LR_Scheduler) pass through."""
        pnames = sorted(mapping, key=len, reverse=True)
        out = {}
        for k, v in sd.items():
            nk = k
            for pn in pnames:
                if k.startswith(pn + "_"):
                    nk = mapping[pn] + k[len(pn):]
                    break
            out[nk] = v
        return out

    def _optimizer_state(self):
        sd = self.optimizer.state_dict()
        if self.train_step is not None:
            # the accumulators are the train step's (train_step_opt)
            sd = {k: v for k, v in sd.items()
                  if k in ("@step", "LR_Scheduler")}
        by_pname, _ = self._name_maps()
        return self._remap_opt_keys(sd, by_pname)

    def save(self, step):
        # back-pressure: a still-running commit of the previous save is
        # joined HERE (error-propagating), and the wait counts into the
        # step-path stall this save reports
        t_stall0 = _time.perf_counter()
        if isinstance(self._last, _AsyncHandle) and self._last.is_alive():
            record("ckpt_backpressure", step=int(step))
        self.wait()
        state = {"step": int(step)}
        ts = self.train_step
        if self.model is not None:
            own = getattr(ts, "_checkpoint_model_state", None)
            state["model"] = own() if own is not None else \
                _model_state(self.model)
        if self.optimizer is not None:
            state["optimizer"] = self._optimizer_state()
        if ts is not None:
            opt_sd = _train_step_opt_states(ts)
            if opt_sd:
                state["train_step_opt"] = opt_sd
        _, nproc = _proc_index()
        t_wall0 = _steptrace.now()
        if nproc == 1 and not self.async_save:
            self._last = self.retry.run(
                save_state_dict, state, self._dir(step),
                name=f"ckpt.save:{step}", _stall_start=t_stall0)
        else:
            self._last = save_state_dict(state, self._dir(step),
                                         async_save=self.async_save,
                                         _stall_start=t_stall0)
        t_wall1 = _steptrace.now()
        # the step path's share of this save; the handle's `committer`
        # reports the commit's seconds and bytes once it has run
        self.last_stats = {"step": int(step),
                           "stall_s": _time.perf_counter() - t_stall0,
                           "committer": self._last.committer}
        # the synchronous slice of this save becomes the next step's
        # ckpt_snapshot phase segment
        _steptrace.note_ckpt_snapshot(t_wall0, t_wall1)
        self._prune()
        return self._last

    def wait(self):
        if self._last is not None:
            self._last.result()
            self._last = None

    def _prune(self):
        if not self.keep:
            return
        rank, _ = _proc_index()
        if rank != 0:
            return
        steps = sorted(self.steps())
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._dir(s), ignore_errors=True)

    def steps(self):
        if not os.path.isdir(self.root):
            return []
        out = []
        for d in os.listdir(self.root):
            if d.startswith("ckpt-") and is_complete(
                    os.path.join(self.root, d)):
                try:
                    out.append(int(d.split("-")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def load_latest(self):
        """Restore from the newest COMPLETE checkpoint. A checkpoint
        that fails its integrity check is journaled and skipped, falling
        back to the next-older one. ONLY torn-checkpoint shapes
        (TornCheckpointError, missing shard files) fall back — a
        transient I/O failure that survives the retry budget, or a
        model/optimizer structure mismatch, propagates."""
        from .resilience import RetryError

        for step in reversed(self.steps()):
            try:
                return self.load(step)
            except TornCheckpointError as e:
                _TORN_FALLBACKS.inc()
                record("ckpt_rejected", step=step, error=str(e))
                continue
            except RetryError as e:
                if isinstance(e.last, FileNotFoundError):
                    _TORN_FALLBACKS.inc()
                    record("ckpt_rejected", step=step, error=str(e))
                    continue
                raise
        return None

    def load(self, step):
        with _trace_span("ckpt.load", step=step):
            state = self.retry.run(load_state_dict, self._dir(step),
                                   name=f"ckpt.load:{step}")
        ts = self.train_step
        if self.model is not None and "model" in state:
            sd = _model_state(self.model)
            missing = [n for n in sd if n not in state["model"]]
            if missing:
                raise ValueError(
                    f"checkpoint is missing model params {missing}; "
                    "model structure differs from the one checkpointed")
            own = getattr(ts, "_restore_model_state", None)
            if own is not None:
                own(state["model"])
            else:
                with torch.no_grad():
                    for name, p in sd.items():
                        p.copy_(state["model"][name].to(
                            device=p.device, dtype=p.dtype))
        if self.optimizer is not None and "optimizer" in state:
            _, by_struct = self._name_maps()
            self.optimizer.set_state_dict(self._remap_opt_keys(
                state["optimizer"], by_struct))
        if ts is not None and "train_step_opt" in state:
            _restore_train_step_opt(ts, state["train_step_opt"])
        return int(state["step"])


# ------------------------------------------- train-step optimizer state

def _train_params(ts):
    """[(structural name, parameter)] of the step's trainable
    parameters — stable across model re-instantiation."""
    return [(n, p) for n, p in ts.model.named_parameters()
            if p.requires_grad]


def _train_step_opt_states(ts):
    """The step's optimizer accumulators, keyed structural-param-name →
    accumulator (a ZeRO step's are its LocalShards)."""
    own = getattr(ts, "_checkpoint_opt_states", None)
    if own is not None:
        return own()
    states = getattr(ts.optimizer, "_states", {})
    out = {}
    for n, p in _train_params(ts):
        st = states.get(id(p))
        if st:
            out[n] = dict(st)
    return out


def _restore_train_step_opt(ts, opt_sd):
    params = _train_params(ts)
    probe = ts.optimizer._init_state(params[0][1]) if params else {}
    if not probe:
        return                  # a stateless optimizer (SGD)
    missing = [n for n, _ in params if n not in opt_sd]
    if missing:
        raise ValueError(
            f"checkpoint is missing optimizer state for params {missing}; "
            "model structure differs from the one checkpointed")
    own = getattr(ts, "_restore_opt_states", None)
    if own is not None:
        own(opt_sd)
        return
    opt = ts.optimizer
    with torch.no_grad():
        for n, p in params:
            state = opt._state_for(p)
            for k, old in list(state.items()):
                if k in opt_sd[n]:
                    state[k] = opt_sd[n][k].to(
                        device=old.device, dtype=old.dtype).clone()
