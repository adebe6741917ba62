"""The port's launcher, membership master and elastic membership
(paddle_tpu_torch/distributed/launch/, fleet/elastic.py) against the
JAX package's.

`_worker_env` hands each worker the reference's env contract, key for
key and value for value (bar the visible-devices variable: CUDA's here,
the TPU's there); the argument parsers agree. A rank that exits 3 fails
the launch with 3 and its sibling is killed; a failed first pod is
restarted under --max_restart with the next pod incarnation. The
membership master's health telemetry (the reference's
test_membership_master_health_telemetry), `ElasticManager` over a
heartbeat directory, `request_scale_out`'s join files and the
`touch_heartbeat` / `remove_heartbeat` protocol match the reference's.
`run_with_fault_tolerance` restores through a Checkpointer (the whole
contract: tests/test_torch_fault_tolerance.py). A kernel build's log is
its process's own until the build succeeds.
"""
import os
import re
import signal
import subprocess
import sys
import textwrap
import time

import pytest

from paddle_tpu.distributed import launch as jlaunch
from paddle_tpu.distributed.fleet import elastic as jel
from paddle_tpu_torch.distributed import launch as tlaunch
from paddle_tpu_torch.distributed.fleet import elastic as tel
from paddle_tpu_torch.distributed.launch.master import (MembershipClient,
                                                        MembershipMaster)

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 120
DEVICE_VARS = ("CUDA_VISIBLE_DEVICES", "TPU_VISIBLE_DEVICES")

ARGVS = [
    ["train.py"],
    ["--nproc_per_node=3", "--log_dir=/x/logs", "--job_id=j7",
     "--elastic_timeout=12", "train.py", "--lr", "0.1"],
    ["--nnodes=2", "--rank=1", "--nproc_per_node=2", "--devices=0,1",
     "--master=10.0.0.1:6170", "--max_restart=2", "--elastic_level=1",
     "train.py"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_parse_args_matches_reference(argv):
    assert vars(tlaunch.parse_args(argv)) == vars(jlaunch.parse_args(argv))


@pytest.mark.parametrize("argv", ARGVS)
@pytest.mark.parametrize("local_rank,nproc,mm,attempt", [
    (0, None, None, 0), (1, None, "127.0.0.1:555", 3), (2, 4, None, 1)])
def test_worker_env_matches_reference(monkeypatch, argv, local_rank, nproc,
                                      mm, attempt):
    for var in DEVICE_VARS:
        monkeypatch.delenv(var, raising=False)
    args = tlaunch.parse_args(argv)
    kw = dict(nproc=nproc, mm_endpoint=mm, attempt=attempt)
    got = tlaunch._worker_env(args, local_rank, "127.0.0.1:7000", **kw)
    want = jlaunch._worker_env(jlaunch.parse_args(argv), local_rank,
                               "127.0.0.1:7000", **kw)
    assert ({k: v for k, v in got.items() if k not in DEVICE_VARS}
            == {k: v for k, v in want.items() if k not in DEVICE_VARS})
    assert got.get("CUDA_VISIBLE_DEVICES") == want.get(
        "TPU_VISIBLE_DEVICES") == args.devices
    assert "TPU_VISIBLE_DEVICES" not in got


def _env(extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env.pop("PT_CHAOS_PLAN", None)
    env.update(extra or {})
    return env


def _run_launch(cmd, env=None, timeout=LAUNCH_TIMEOUT_S):
    """Run the launcher in a session of its own; on a timeout SIGTERM it
    (it kills its pod's process group), then SIGKILL what is left."""
    p = subprocess.Popen(cmd, env=env or _env(), cwd=ROOT,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, start_new_session=True)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGTERM)
        try:
            out, err = p.communicate(timeout=20)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            out, err = p.communicate()
        pytest.fail(f"launch timed out after {timeout} s\n{out}\n{err}")
    return p.returncode, out, err


FAIL_SCRIPT = textwrap.dedent('''
    import os, sys, time
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    out = sys.argv[1]
    with open(os.path.join(out, f"pid{rank}"), "w") as f:
        f.write(f"{os.getpid()} {os.getpgid(0)} "
                f"{os.environ.get('PADDLE_MASTER_HOSTED')} "
                f"{os.environ['PADDLE_MASTER']}")
    if rank == 1:
        time.sleep(0.5)
        sys.exit(3)
    time.sleep(120)
''')


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def test_a_dying_rank_fails_the_launch_and_kills_its_sibling(tmp_path):
    script = tmp_path / "fail.py"
    script.write_text(FAIL_SCRIPT)
    t0 = time.monotonic()
    rc, out, err = _run_launch(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node=2", f"--log_dir={tmp_path}/log", str(script),
         str(tmp_path)])
    assert rc == 3, err
    assert time.monotonic() - t0 < 60
    assert "worker rank 1 exited with 3" in err
    rows = [(tmp_path / f"pid{r}").read_text().split() for r in range(2)]
    pids = [int(r[0]) for r in rows]
    # one process group for the pod, not the launcher's
    assert rows[0][1] == rows[1][1] == str(pids[0])
    # the launcher hosts the store and names its port
    assert rows[0][2] == rows[1][2] == "1"
    assert re.fullmatch(r"127\.0\.0\.1:\d+", rows[0][3])
    assert not _alive(pids[0]) and not _alive(pids[1])
    assert (tmp_path / "log" / "default.rank1.log").exists()


RESTART_SCRIPT = textwrap.dedent('''
    import os, sys
    attempt = os.environ["PADDLE_POD_ATTEMPT"]
    with open(os.path.join(sys.argv[1], "attempts"), "a") as f:
        f.write(attempt + os.environ["PADDLE_TRAINER_ID"] + "\\n")
    sys.exit(1 if attempt == "0" else 0)
''')


def test_max_restart_reforms_the_pod(tmp_path):
    script = tmp_path / "flaky.py"
    script.write_text(RESTART_SCRIPT)
    rc, out, err = _run_launch(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node=2", "--max_restart=1",
         f"--log_dir={tmp_path}/log", str(script), str(tmp_path)])
    assert rc == 0, err
    assert "restart 1/1" in err
    got = sorted((tmp_path / "attempts").read_text().split())
    assert got[-2:] == ["10", "11"] and got[0] in ("00", "01")


def test_membership_master_health_telemetry():
    mm = MembershipMaster()
    try:
        client = MembershipClient(mm.endpoint)
        assert mm.endpoint.startswith("127.0.0.1:")
        client.beat(0)
        client.beat(1, degraded=True, retries=5)
        health = client.health()
        assert health[0]["degraded"] is False
        assert health[1]["degraded"] is True and health[1]["retries"] == 5
        assert mm.health()[1]["degraded"] is True
        assert [r for r, _ in client.peers()] == [0, 1]
        client.clear(1)
        assert 1 not in client.health()
        client.join(2)
        assert client.pending_joins() == 2 == mm.pending_joins()
        assert mm.consume_joins(1) == 1 and mm.pending_joins() == 1
        assert tel.request_scale_out(3, master=mm.endpoint) == 3
        assert mm.pending_joins() == 4
        mm.reset_beats()
        assert client.peers() == []
    finally:
        mm.close()


def _elastic_views(mod, monkeypatch, hb_dir, timeout):
    monkeypatch.setenv("PADDLE_HEARTBEAT_DIR", str(hb_dir))
    monkeypatch.setenv("PADDLE_ELASTIC_TIMEOUT", str(timeout))
    monkeypatch.delenv("PADDLE_ELASTIC_MASTER", raising=False)
    em = mod.ElasticManager()
    return (em.enabled, [r for r, _ in em.peers()], em.watch(),
            em.pending_joins(), em.health())


def test_elastic_manager_over_a_heartbeat_dir(monkeypatch, tmp_path):
    hb = tmp_path / "hb"
    for r in (0, 1, 2):
        tel.touch_heartbeat(str(hb), r)
    old = time.time() - 100
    os.utime(hb / "hb_2", (old, old))
    for timeout in (30.0, 300.0):
        got = _elastic_views(tel, monkeypatch, hb, timeout)
        assert got == _elastic_views(jel, monkeypatch, hb, timeout)
    assert got[1] == [0, 1, 2] and got[2] == tel.ElasticStatus.HOLD
    fresh = _elastic_views(tel, monkeypatch, hb, 30.0)
    assert fresh[2] == tel.ElasticStatus.RESTART
    assert tel._PEERS.value == 3 and tel._STALE_PEERS.value == 1
    tel.remove_heartbeat(str(hb), 2)
    tel.remove_heartbeat(str(hb), 2)           # idempotent
    assert _elastic_views(tel, monkeypatch, hb, 30.0)[1:3] == (
        [0, 1], tel.ElasticStatus.HOLD)
    assert ("2",) not in tel._PEER_AGE._children
    em = tel.ElasticManager()
    em.exit(completed=False)
    assert em.watch() == tel.ElasticStatus.ERROR
    assert tel.ELASTIC_EXIT_CODE == jel.ELASTIC_EXIT_CODE


def test_request_scale_out_join_files_match_reference(monkeypatch,
                                                      tmp_path):
    monkeypatch.delenv("PADDLE_ELASTIC_MASTER", raising=False)
    monkeypatch.delenv("PADDLE_NNODES", raising=False)
    names = {}
    for mod in (jel, tel):
        hb = tmp_path / mod.__name__.split(".")[0]
        assert mod.request_scale_out(2, hb_dir=str(hb)) == 2
        names[mod] = sorted(os.listdir(hb))
        assert [os.path.basename(p) for p in
                mod.pending_join_files(str(hb))] == names[mod]
        monkeypatch.setenv("PADDLE_HEARTBEAT_DIR", str(hb))
        assert mod.ElasticManager().pending_joins() == 2
        # the launcher counts the same files
        assert len(tlaunch._pending_joins(str(hb))) == 2
    for mod, files in names.items():
        assert len(files) == 2
        assert all(re.fullmatch(r"join_[0-9a-f]{8}", f) for f in files)
    monkeypatch.delenv("PADDLE_HEARTBEAT_DIR")
    with pytest.raises(RuntimeError, match="PADDLE_HEARTBEAT_DIR"):
        tel.request_scale_out(1)


def test_heartbeat_files_match_reference(tmp_path):
    for mod in (jel, tel):
        d = tmp_path / mod.__name__.split(".")[0]
        path = mod.touch_heartbeat(str(d), 4)
        assert os.path.basename(path) == "hb_4"
        assert abs(float(open(path).read()) - time.time()) < 60
    assert (sorted(os.listdir(tmp_path / "paddle_tpu"))
            == sorted(os.listdir(tmp_path / "paddle_tpu_torch")))


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """init_parallel_env and profile_disagg run on CUDA unless asked for
    the CPU, and raise where there is no GPU."""
    import torch

    from paddle_tpu_torch import distributed as tdist
    from paddle_tpu_torch import profile_disagg

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for var in ("PADDLE_TRAINERS_NUM", "PADDLE_MASTER"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdist.init_parallel_env()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profile_disagg.main(["--out", str(tmp_path)])
    assert profile_disagg.parse_args(["--out", "x"]).device == "cuda"
    # one process, on the CPU: the world group, collectives the identity
    g = tdist.init_parallel_env(device="cpu")
    assert (g.nranks, g.rank, tdist.is_initialized()) == (1, 0, True)
    t = torch.tensor([2.0, 3.0])
    assert tdist.all_reduce(t) is t and t.tolist() == [2.0, 3.0]
    # a mesh axis of a one-process world: a group of one, the identity
    mp = tdist.new_group(axes=("mp",))
    assert (mp.axes, mp.nranks, mp.rank) == (("mp",), 1, 0)
    assert tdist.all_reduce(t, group=mp) is t and t.tolist() == [2.0, 3.0]


def test_run_with_fault_tolerance_raises_naming_a11(tmp_path):
    """(The loop no longer raises: ROADMAP A11(b) part 1 ported it.) A
    failed first attempt restores the Checkpointer's latest complete
    checkpoint and re-enters at its step."""
    import torch

    from paddle_tpu_torch.distributed.checkpoint import Checkpointer

    w = torch.nn.Parameter(torch.zeros(2))
    ck = Checkpointer(str(tmp_path / "ck"), model=torch.nn.ParameterList(
        [w]))
    starts = []

    def train_fn(start):
        starts.append(start)
        for s in range(start, 4):
            with torch.no_grad():
                w.add_(1.0)
            ck.save(s + 1)
            if s == 2 and len(starts) == 1:
                raise RuntimeError("lost a worker")
        return 4

    assert tel.run_with_fault_tolerance(train_fn, ck) == 4
    assert starts == [0, 3] and w.tolist() == [4.0, 4.0]


def test_kernel_build_log_is_per_process_until_it_succeeds(monkeypatch,
                                                           tmp_path):
    """A fake nvcc: a failed build leaves the failing process's own log
    (named by its pid); a good build's log is the library's."""
    from paddle_tpu_torch.ops.cuda_kernels import _build

    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// FAIL\n")
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(textwrap.dedent('''\
        #!/bin/sh
        for a; do src="$a"; done
        echo "ptxas info: fake build of $src"
        for a; do prev="$o"; o="$a"; [ "$prev" = "-o" ] && tgt="$a"; done
        grep -q FAIL "$src" && exit 2
        echo lib > "$tgt"
        '''))
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(out))
    with pytest.raises(RuntimeError, match=rf"k \(nvcc exit 2, log .*"
                       rf"\.{os.getpid()}\.log\)"):
        _build.build(["k"])
    logs = [f for f in os.listdir(out) if f.endswith(".log")]
    assert logs == [f"{_build._target('k')[1][:-3]}.{os.getpid()}.log"
                    .rsplit("/", 1)[1]]
    (csrc / "k.cu").write_text("// ok\n")
    so = _build.build(["k"])["k"]
    assert os.path.exists(so)
    assert "fake build" in open(so[:-3] + ".log").read()
    assert not any(f.endswith(".tmp") for f in os.listdir(out))
