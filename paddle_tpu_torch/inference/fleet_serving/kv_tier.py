"""Hierarchical KV memory — host-RAM and disk spill tiers under the
serving fleet (counterpart of
paddle_tpu/inference/fleet_serving/kv_tier.py).

The radix prefix cache (prefix_cache.py) is bounded by one device pool:
when LRU eviction drops a trie node, its KV is recomputed on the next
hit. This store keeps evicted prefixes alive below the card's memory:

* **Spill.** The engine gathers the dying node's pages to the host
  synchronously (`LLMEngine._gather_pages`, on the engine's stream under
  its device gate, so a queued window can never still be writing a page
  the snapshot reads) and hands the owned host arrays to `put`. The slow
  part — packing the frame, the RAM index, any disk write — runs on a
  background commit thread that never touches the step path. A failed
  commit journals (`distributed.resilience`) and drops the entry: a lost
  spill costs only the re-prefill the eviction was going to cost anyway.
* **Zero re-encode.** Entries are `KVPagePayload` frames (the KV wire's
  format): codes and f32 scale planes byte for byte as the pool held
  them, so a spill -> prefetch round trip is byte-identical and a frame
  written by either package reads in the other.
* **RAM over disk, LRU both.** The RAM tier is an LRU dict under a byte
  budget; overflow demotes the oldest frames to a disk tier (when a
  directory is given) of one ``.ptkv`` file per prefix, written
  tmp-then-rename so a kill mid-write never leaves a half frame under a
  live name. A restart re-scans the directory: ``.tmp`` leftovers and
  unparseable frames are removed, intact frames adopted.
* **Prefetch.** A trie miss against a spilled prefix writes its pages
  back through the engine's `_write_imported_pages` (`index_copy_` into
  the pools in place: captured CUDA graphs hold the pool addresses) and
  re-inserts the node.

Keys are the trie's own identity (`prefix_key`): the int32 bytes of the
full token prefix a node covers. A frame carries the full prefix tokens
but only the node's own block pages (parent blocks are separate
entries).

Telemetry: the `pt_kv_tier_*{tier}` family (the `hbm` rows are published
by the engine that owns the pool), `pt_kv_migrations_total` (router page
pulls) and the `pt_session_*` pair (persistent chat sessions).
"""
import collections
import hashlib
import json
import os
import queue
import threading

import numpy as np

from ...distributed import chaos, resilience
from ...observability import metrics as _obs
from .kv_transfer import (_HDR, _MAGIC, _VERSION, KVPagePayload,
                          _np_dtype, pack_kv_payload, unpack_kv_payload)

__all__ = ["KVTierStore", "prefix_key"]

_TIER_BYTES = _obs.gauge(
    "pt_kv_tier_bytes",
    "resident bytes per KV memory tier (hbm = live pool pages, "
    "published by the engine; ram/disk = packed payload frames)",
    labelnames=("tier",))
_TIER_PAGES = _obs.gauge(
    "pt_kv_tier_pages",
    "resident KV pages per memory tier (hbm = live pool pages)",
    labelnames=("tier",))
_TIER_HITS = _obs.counter(
    "pt_kv_tier_hits",
    "prefix lookups served per tier (hbm = trie hits at admission; "
    "ram/disk = spilled frames prefetched back into the pool)",
    labelnames=("tier",))
_TIER_EVICTIONS = _obs.counter(
    "pt_kv_tier_evictions",
    "pages leaving a tier downward (hbm -> spill queue, ram -> disk "
    "or dropped, disk -> dropped), by the tier they left",
    labelnames=("tier",))
_MIGRATIONS = _obs.counter(
    "pt_kv_migrations_total",
    "hot-prefix page migrations pulled to a second replica over the "
    "byte-exact KV wire instead of routing around the miss")
_SESSION_ACTIVE = _obs.gauge(
    "pt_session_active",
    "chat sessions currently tracked (pinned-then-tiered trie "
    "frontiers awaiting their next turn)")
_SESSION_RESUMED = _obs.counter(
    "pt_session_resumed",
    "session turns that resumed from a cached frontier instead of "
    "re-prefilling the conversation history")

_SUFFIX = ".ptkv"


def prefix_key(tokens):
    """Byte fingerprint of a token prefix — content AND position, the
    shared identity of router affinity keys, trie node paths, and tier
    entries."""
    return np.asarray(tokens, np.int32).tobytes()


def _mmap_array(f, path):
    """One npy array as a read-only `np.memmap` over the OS page
    cache: parse the npy header off the stream, map the data span in
    place, and advance `f` past it exactly like `np.load` would — but
    with ZERO eager host copy. The bytes materialize lazily as the
    prefetch scatter touches them; a frame evicted while a mapping is
    live stays readable (POSIX unlink keeps the open mapping valid)."""
    version = np.lib.format.read_magic(f)
    if version == (1, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
    elif version == (2, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
    else:
        raise ValueError(f"unsupported npy version {version}: {path}")
    if dtype.hasobject:
        raise ValueError(f"object array in KV frame: {path}")
    offset = f.tell()
    count = int(np.prod(shape, dtype=np.int64))
    arr = np.memmap(path, dtype=dtype, mode="r", offset=offset,
                    shape=shape, order="F" if fortran else "C")
    f.seek(offset + count * dtype.itemsize)
    return arr


def _read_frame(path, use_mmap=False):
    """Parse one on-disk PTKV frame STREAMING from the file handle
    (np.load per array straight off the OS page cache — no whole-frame
    host copy on the read path). With ``use_mmap`` the array payloads
    are `np.memmap` views instead of copies — byte-identical (pinned
    by tests/test_torch_kv_tier.py), just lazier. Raises on any
    truncation/corruption; callers GC the file."""
    with open(path, "rb") as f:
        hdr = f.read(_HDR.size)
        if len(hdr) != _HDR.size:
            raise ValueError(f"truncated frame header: {path}")
        magic, ver, meta_len = _HDR.unpack(hdr)
        if magic != _MAGIC:
            raise ValueError(f"not a KV frame (magic {magic!r}): {path}")
        if ver != _VERSION:
            raise ValueError(f"KV frame version {ver} != {_VERSION}")
        meta = json.loads(f.read(meta_len).decode("utf-8"))
        if use_mmap:
            def rd():
                return _mmap_array(f, path)
        else:
            def rd():
                return np.load(f, allow_pickle=False)
        tokens = rd()
        kv = [rd() for _ in range(meta["n_kv"])]
        scales = [rd() for _ in range(meta["n_scales"])]
    kv = [a if a.dtype == _np_dtype(n) else a.view(_np_dtype(n))
          for a, n in zip(kv, meta["pool_dtypes"])]
    return KVPagePayload(tokens, meta["n_prefilled"], meta["page_size"],
                         meta["kv_dtype"], kv, scales,
                         trace=meta.get("trace"))


class KVTierStore:
    """Host-RAM + disk spill tiers for evicted prefix-cache pages
    (module docstring). One store per engine; `put` is called on the
    engine thread at trie eviction with an already-snapshotted host
    payload, `get` on the engine thread at admission, the commit work
    on this store's own background thread.

    ram_bytes    RAM-tier byte budget for packed frames
    disk_dir     directory for the cold tier (None: RAM only —
                 RAM overflow is simply dropped)
    disk_bytes   disk-tier byte budget (LRU by last hit)
    max_pending  spill-queue bound: a saturated commit thread REJECTS
                 new spills (counted, journal-free) instead of ever
                 blocking the engine thread
    mmap         disk-tier read path: True maps frames with np.memmap
                 (lazy, zero eager copy — default), False streams with
                 np.load. None reads env PT_KV_TIER_MMAP ("0" opts
                 out). Byte-identity either way.
    """

    def __init__(self, ram_bytes=256 << 20, disk_dir=None,
                 disk_bytes=1 << 30, max_pending=64, mmap=None):
        self.ram_bytes = int(ram_bytes)
        self.disk_dir = disk_dir
        self.disk_bytes = int(disk_bytes) if disk_dir else 0
        if mmap is None:
            mmap = os.environ.get(
                "PT_KV_TIER_MMAP", "1").lower() not in ("0", "false")
        self.use_mmap = bool(mmap)
        self._lock = threading.Lock()
        self._ram = collections.OrderedDict()   # key -> (frame, pages)
        self._ram_used = 0
        self._disk = collections.OrderedDict()  # key -> (path, nbytes,
        self._disk_used = 0                     #         pages)
        # delta-published gauges (several engines' stores SUM into the
        # process-global cells instead of last-writer-wins)
        self._published = {("bytes", "ram"): 0, ("bytes", "disk"): 0,
                           ("pages", "ram"): 0, ("pages", "disk"): 0}
        self.stats = {"spills": 0, "spill_pages": 0, "spill_failed": 0,
                      "spill_rejected": 0, "ram_hits": 0,
                      "disk_hits": 0, "misses": 0, "demotions": 0,
                      "ram_dropped": 0, "disk_dropped": 0,
                      "gc_files": 0, "adopted": 0, "mmap_reads": 0}
        if self.disk_dir:
            os.makedirs(self.disk_dir, exist_ok=True)
            self._restart_scan()
        self._jobs = queue.Queue(maxsize=int(max_pending))
        self._running = True
        self._thread = threading.Thread(
            target=self._commit_loop, name="kv-tier-commit", daemon=True)
        self._thread.start()

    # ---- restart hygiene (chaos: SIGKILL with a warm tier) ----

    def _restart_scan(self):
        """Adopt intact frames left by a previous process; GC `.tmp`
        leftovers (a rename that never happened) and frames that fail
        to parse (a torn write can only exist as a .tmp, but a corrupt
        disk is cheap to defend against while we're here)."""
        for name in sorted(os.listdir(self.disk_dir)):
            path = os.path.join(self.disk_dir, name)
            if name.endswith(".tmp"):
                self._gc_file(path)
                continue
            if not name.endswith(_SUFFIX):
                continue
            try:
                payload = _read_frame(path)
                key = prefix_key(payload.tokens)
            except Exception as e:
                self._gc_file(path, error=repr(e))
                continue
            with self._lock:
                self._disk[key] = (path, os.path.getsize(path),
                                   payload.num_pages)
                self._disk_used += os.path.getsize(path)
                self.stats["adopted"] += 1
        with self._lock:
            self._publish_locked()

    def _gc_file(self, path, error=None):
        # never called with the lock held (init scan / post-lock drop)
        try:
            os.remove(path)
            with self._lock:
                self.stats["gc_files"] += 1
            resilience.record("kv_tier_gc", path=os.path.basename(path),
                              error=error)
        except OSError:
            pass

    # ---- spill (engine thread enqueues; commit thread owns the work) ----

    def put(self, key, payload):
        """Queue one evicted prefix for tiering. `payload` must already
        be host-resident owned arrays (the engine's synchronous D2H
        snapshot); this call is O(1) and NEVER blocks — a full queue
        rejects the spill (the entry is simply lost, like any other
        eviction) rather than stall the serve loop. Returns True when
        queued."""
        if not self._running:
            return False
        try:
            self._jobs.put_nowait((key, payload))
        except queue.Full:
            with self._lock:
                self.stats["spill_rejected"] += 1
            return False
        return True

    def _commit_loop(self):
        while True:
            job = self._jobs.get()
            try:
                if job is None:
                    return
                key, payload = job
                try:
                    chaos.fire("kv_tier.spill")
                    frame = pack_kv_payload(payload)
                    self._insert_ram(key, frame, payload.num_pages)
                    with self._lock:
                        self.stats["spills"] += 1
                        self.stats["spill_pages"] += payload.num_pages
                except Exception as e:
                    # journal + drop: a failed commit costs exactly the
                    # re-prefill the eviction already cost — serving
                    # correctness never depends on the tier
                    with self._lock:
                        self.stats["spill_failed"] += 1
                    try:
                        resilience.record("kv_tier_spill_failed",
                                          error=repr(e),
                                          pages=payload.num_pages)
                    except Exception:
                        pass
            finally:
                self._jobs.task_done()

    def _insert_ram(self, key, frame, pages):
        """RAM-tier insert + LRU demotion cascade. Victim frames are
        collected under the lock but written to disk OUTSIDE it, so a
        concurrent `get` on the engine thread never waits on disk I/O
        (worst case it misses a frame mid-demotion and re-prefills)."""
        demote = []
        with self._lock:
            if key in self._ram:
                self._ram.move_to_end(key)
                return
            self._ram[key] = (frame, pages)
            self._ram_used += len(frame)
            while self._ram_used > self.ram_bytes and self._ram:
                vk, (vframe, vpages) = self._ram.popitem(last=False)
                self._ram_used -= len(vframe)
                demote.append((vk, vframe, vpages))
            self._publish_locked()
        for vk, vframe, vpages in demote:
            _TIER_EVICTIONS.labels(tier="ram").inc(vpages)
            if self.disk_dir:
                self._demote_disk(vk, vframe, vpages)
            else:
                with self._lock:
                    self.stats["ram_dropped"] += 1

    def _demote_disk(self, key, frame, pages):
        """One frame RAM -> disk: tmp-write + rename (the
        visibility rule: a reader, or a restart scan, only ever sees
        whole frames), then LRU-trim the disk tier to budget."""
        path = os.path.join(
            self.disk_dir, hashlib.sha1(key).hexdigest() + _SUFFIX)
        try:
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(frame)
            os.replace(tmp, path)
        except OSError as e:
            try:
                resilience.record("kv_tier_disk_failed", error=repr(e))
            except Exception:
                pass
            return
        drop = []
        with self._lock:
            old = self._disk.pop(key, None)
            if old is not None:
                self._disk_used -= old[1]
            self._disk[key] = (path, len(frame), pages)
            self._disk_used += len(frame)
            self.stats["demotions"] += 1
            while self._disk_used > self.disk_bytes and self._disk:
                _, (vpath, vbytes, vpages) = self._disk.popitem(
                    last=False)
                self._disk_used -= vbytes
                self.stats["disk_dropped"] += 1
                drop.append((vpath, vpages))
            self._publish_locked()
        for vpath, vpages in drop:
            _TIER_EVICTIONS.labels(tier="disk").inc(vpages)
            try:
                os.remove(vpath)
            except OSError:
                pass

    # ---- prefetch lookups (engine thread) ----

    def get(self, key):
        """The tier lookup behind a trie miss: RAM frame, else disk
        frame (LRU-touched), else None. Returns the unpacked
        `KVPagePayload` — byte-identical arrays to what was spilled."""
        with self._lock:
            ent = self._ram.get(key)
            if ent is not None:
                self._ram.move_to_end(key)
                self.stats["ram_hits"] += 1
            else:
                dent = self._disk.get(key)
                if dent is not None:
                    self._disk.move_to_end(key)   # LRU by last HIT
                    self.stats["disk_hits"] += 1
                else:
                    self.stats["misses"] += 1
                    return None
        if ent is not None:
            _TIER_HITS.labels(tier="ram").inc()
            return unpack_kv_payload(ent[0])
        _TIER_HITS.labels(tier="disk").inc()
        try:
            payload = _read_frame(dent[0], use_mmap=self.use_mmap)
            if self.use_mmap:
                with self._lock:
                    self.stats["mmap_reads"] += 1
            return payload
        except Exception as e:
            # a frame that rots on disk is dropped like a failed spill
            with self._lock:
                old = self._disk.pop(key, None)
                if old is not None:
                    self._disk_used -= old[1]
                self._publish_locked()
            self._gc_file(dent[0], error=repr(e))
            return None

    def __contains__(self, key):
        with self._lock:
            return key in self._ram or key in self._disk

    # ---- lifecycle / introspection ----

    def flush(self):
        """Drain the spill queue (tests and the bench's deterministic
        A/B phases — production never waits on the tier)."""
        self._jobs.join()

    def close(self):
        if not self._running:
            return
        self._running = False
        self._jobs.put(None)
        self._thread.join(timeout=10)

    def _publish_locked(self):
        ram_pages = sum(p for _, p in list(self._ram.values()))
        disk_pages = sum(p for _, _, p in list(self._disk.values()))
        cur = {("bytes", "ram"): self._ram_used,
               ("bytes", "disk"): self._disk_used,
               ("pages", "ram"): ram_pages,
               ("pages", "disk"): disk_pages}
        for (what, tier), val in cur.items():
            gauge = _TIER_BYTES if what == "bytes" else _TIER_PAGES
            gauge.labels(tier=tier).inc(val - self._published[
                (what, tier)])
            self._published[(what, tier)] = val

    def snapshot(self):
        with self._lock:
            out = dict(self.stats)
            out.update({
                "ram_bytes": self._ram_used,
                "ram_entries": len(self._ram),
                "disk_bytes": self._disk_used,
                "disk_entries": len(self._disk),
                "pending": self._jobs.qsize(),
            })
        return out
