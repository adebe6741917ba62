"""Membership master — cross-host worker registry for elastic jobs
(counterpart of paddle_tpu/distributed/launch/master.py; the same
protocol, ops and replies).

The LAUNCHER hosts this tiny TCP registry: it outlives pod restarts (it
belongs to the launcher process), needs no shared filesystem, and works
across hosts: workers and operators talk to it via one `host:port`
endpoint (env ``PADDLE_ELASTIC_MASTER``).

Protocol: one JSON object per line over a short-lived connection —
heartbeat rates are ~1/s/worker, far below any framing concern.

  {"op": "beat", "rank": R}        register/refresh worker R
  {"op": "clear", "rank": R}       deregister (clean exit tombstone)
  {"op": "join", "n": N}           request N workers admitted (operator)
  {"op": "peers"}                  -> {"peers": {"R": age_seconds, ...}}
  {"op": "health"}                 -> {"health": {"R": {age, degraded,
                                       retries}, ...}}
  {"op": "joins"}                  -> {"count": pending join requests}
  {"op": "consume_joins", "n": N}  consume N requests (launcher)
  {"op": "reset"}                  drop all beats (pod re-form)

The heartbeat-DIRECTORY protocol (hb_*/join_* files) remains as the
fallback when no master endpoint is set — zero-dependency single-host
operation.
"""
import json
import os
import socket
import threading
import time

__all__ = ["MembershipMaster", "MembershipClient", "master_endpoint"]


# the heartbeat directory's join-request files, shared by
# fleet.elastic.request_scale_out (writer), ElasticManager.pending_joins
# and the launcher's watch (readers)
JOIN_PREFIX = "join_"


def pending_join_files(hb_dir):
    """Absolute paths of join_* request files in the heartbeat dir."""
    if not hb_dir or not os.path.isdir(hb_dir):
        return []
    return sorted(
        os.path.join(hb_dir, f) for f in os.listdir(hb_dir)
        if f.startswith(JOIN_PREFIX))


def master_endpoint():
    """The job's membership-master endpoint, if one is active."""
    return os.environ.get("PADDLE_ELASTIC_MASTER") or None


def _advertise_ip(route_via=None):
    """Address this host is reachable at: route toward the job
    coordinator (every rank provably reaches it) and read the socket's
    own name; loopback for single-host jobs, which never probe a route.
    Override with PADDLE_TPU_MASTER_ADVERTISE. Same recipe as
    xproc._local_ip (the p2p transport's endpoint publication)."""
    if route_via and route_via.rsplit(":", 1)[0] not in (
            "127.0.0.1", "localhost", ""):
        hp = route_via.rsplit(":", 1)
        target = (hp[0], int(hp[1]) if len(hp) > 1 and hp[1].isdigit()
                  else 80)
        try:
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            try:
                s.connect(target)       # UDP: picks a route, sends nothing
                return s.getsockname()[0]
            finally:
                s.close()
        except OSError:
            pass
    return "127.0.0.1"


class MembershipMaster:
    """Threaded TCP registry. Start in the launcher (or any supervisor
    process); hand `endpoint` to workers via PADDLE_ELASTIC_MASTER."""

    def __init__(self, host="0.0.0.0", advertise=None, route_via=None):
        self._beats = {}          # rank -> last beat time
        self._health = {}         # rank -> {"degraded": bool, "retries": n}
        self._joins = 0
        self._lock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, 0))
        self._sock.listen(64)
        port = self._sock.getsockname()[1]
        adv = (advertise
               or os.environ.get("PADDLE_TPU_MASTER_ADVERTISE")
               or _advertise_ip(route_via))
        self.endpoint = f"{adv}:{port}"
        self._thread = threading.Thread(
            target=self._serve, name="membership-master", daemon=True)
        self._thread.start()

    # -- server --
    def _serve(self):
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _handle(self, conn):
        try:
            with conn, conn.makefile("rw", encoding="utf-8") as f:
                line = f.readline()
                if not line:
                    return
                req = json.loads(line)
                resp = self._dispatch(req)
                f.write(json.dumps(resp) + "\n")
                f.flush()
        except (OSError, ValueError):
            pass

    def _dispatch(self, req):
        op = req.get("op")
        with self._lock:
            if op == "beat":
                r = int(req["rank"])
                self._beats[r] = time.time()
                # degraded-vs-dead: a beat can carry retry telemetry
                # (resilience.recent_failures) — the rank is alive but
                # retry-storming; monitors log it instead of failing
                # the pod
                self._health[r] = {
                    "degraded": bool(req.get("degraded", False)),
                    "retries": int(req.get("retries", 0))}
                return {"ok": True}
            if op == "clear":
                self._beats.pop(int(req["rank"]), None)
                self._health.pop(int(req["rank"]), None)
                return {"ok": True}
            if op == "join":
                self._joins += int(req.get("n", 1))
                return {"ok": True}
            if op == "peers":
                now = time.time()
                return {"peers": {str(r): now - t
                                  for r, t in self._beats.items()}}
            if op == "health":
                return {"health": {str(r): h
                                   for r, h in self._health_view().items()}}
            if op == "joins":
                return {"count": self._joins}
            if op == "consume_joins":
                n = min(self._joins, int(req.get("n", self._joins)))
                self._joins -= n
                return {"consumed": n}
            if op == "reset":
                self._beats.clear()
                return {"ok": True}
        return {"error": f"unknown op {op!r}"}

    # -- launcher-side local views (no socket round-trip) --
    def peers(self):
        now = time.time()
        with self._lock:
            return [(r, now - t) for r, t in sorted(self._beats.items())]

    def _health_view(self):
        """rank -> {age, degraded, retries}. Caller holds self._lock."""
        now = time.time()
        return {r: {"age": now - t,
                    **self._health.get(r, {"degraded": False,
                                           "retries": 0})}
                for r, t in sorted(self._beats.items())}

    def health(self):
        """rank -> {age, degraded, retries} local view (launcher-side)."""
        with self._lock:
            return self._health_view()

    def pending_joins(self):
        with self._lock:
            return self._joins

    def consume_joins(self, n=None):
        with self._lock:
            take = self._joins if n is None else min(n, self._joins)
            self._joins -= take
            return take

    def clear_rank(self, rank):
        """Deregister a cleanly-exited worker (launcher-side)."""
        with self._lock:
            self._beats.pop(int(rank), None)
            self._health.pop(int(rank), None)

    def reset_beats(self):
        with self._lock:
            self._beats.clear()
            self._health.clear()

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


class MembershipClient:
    """One-RPC-per-call client (workers beat ~1/s; operators post joins)."""

    def __init__(self, endpoint, timeout=10.0):
        host, port = endpoint.rsplit(":", 1)
        self._addr = (host, int(port))
        self._timeout = timeout

    def _rpc(self, req):
        with socket.create_connection(self._addr,
                                      timeout=self._timeout) as s:
            with s.makefile("rw", encoding="utf-8") as f:
                f.write(json.dumps(req) + "\n")
                f.flush()
                line = f.readline()
        return json.loads(line) if line else {}

    def beat(self, rank, degraded=False, retries=0):
        """Heartbeat, optionally carrying retry telemetry: degraded=True
        marks the rank as alive-but-retry-storming (distinct from dead —
        the launcher logs it rather than failing the pod)."""
        req = {"op": "beat", "rank": int(rank)}
        if degraded or retries:
            req["degraded"] = bool(degraded)
            req["retries"] = int(retries)
        return self._rpc(req)

    def health(self):
        """rank -> {age, degraded, retries} for every beating worker."""
        got = self._rpc({"op": "health"}).get("health", {})
        return {int(r): h for r, h in got.items()}

    def clear(self, rank):
        return self._rpc({"op": "clear", "rank": int(rank)})

    def join(self, n=1):
        return self._rpc({"op": "join", "n": int(n)})

    def peers(self):
        got = self._rpc({"op": "peers"}).get("peers", {})
        return [(int(r), age) for r, age in sorted(
            got.items(), key=lambda kv: int(kv[0]))]

    def pending_joins(self):
        return int(self._rpc({"op": "joins"}).get("count", 0))
