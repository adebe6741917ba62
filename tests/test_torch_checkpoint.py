"""The Checkpointer (paddle_tpu_torch/distributed/checkpoint.py) against
the JAX package's: the applicable cases of tests/test_checkpoint.py on
the port, and checkpoints crossing between the packages.

Round trips (nested, bf16, lists and bytes, empty containers), async
atomicity and an owned snapshot, keep / prune, the meta integrity
record, torn checkpoints (a truncated shard, a truncated meta.json, the
load_latest fallback), the commit protocol's files and world, a missing
DONE marker (also for another rank's world), an overlapped save
returning before its commit, back-pressure, chaos scope rank targeting,
the kill window, and kill / resume matching the uninterrupted run.

Across the packages: a checkpoint the JAX package's Checkpointer wrote
after 3 `TrainStep` steps on gpt_tiny resumes in the port, and 3 more
steps on both sides agree (losses 1e-5 relative, parameters 1e-4
max-abs: test_torch_train's AdamW trajectory bounds); a port checkpoint
reads back through the reference's `load_state_dict` with equal arrays,
and its meta.json has the reference's fields; a bf16 leaf the JAX
package wrote loads as bf16 through the uint16 storage, without
ml_dtypes. Resumes within the port are exact (equality).
"""
import json
import os
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.distributed import checkpoint as jck
from paddle_tpu.text.models import GPTForCausalLM as JaxGPT
from paddle_tpu.text.models import GPTPretrainingCriterion as JaxCrit
from paddle_tpu.text.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.convert import (export_state_dict,
                                      load_jax_optimizer_state,
                                      load_jax_state_dict)
from paddle_tpu_torch.distributed import chaos, resilience
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.optimizer import SGD, AdamW
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.text.models.gpt import (GPTForCausalLM,
                                              GPTPretrainingCriterion,
                                              gpt_tiny)

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes at once, and torch's thread pool oversubscribes the
    cores then (small ops slow down tenfold); results do not change."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_fsync(monkeypatch):
    monkeypatch.setattr(ckpt, "_FSYNC", False)


def _tiny_model_and_data(seed=0):
    rng = np.random.default_rng(seed)
    m = pnn.Sequential(pnn.Linear(8, 16, device="cpu"), pnn.ReLU(),
                       pnn.Linear(16, 4, device="cpu"))
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.from_numpy(
                rng.standard_normal(tuple(p.shape)).astype(np.float32)
                * 0.3))
    data = np.random.default_rng(3)
    xs = torch.from_numpy(data.standard_normal((16, 8)).astype(np.float32))
    ys = torch.from_numpy(data.integers(0, 4, (16,)))
    return m, xs, ys


def _loss_fn(m, x, y):
    return F.cross_entropy(m(x), y)


def _leaf_file(path, leaf=0):
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)["leaves"][leaf]["shards"][0]["file"]


# ---------------------------------------------------------------- format

def test_roundtrip_nested(tmp_path):
    state = {"model": {"w": torch.arange(12.0).reshape(3, 4)},
             "opt": {"m": torch.ones((2, 2)), "@step": 7},
             "note": "hello", "arr": np.arange(3, dtype=np.int32)}
    ckpt.save_state_dict(state, str(tmp_path / "c1"))
    back = ckpt.load_state_dict(str(tmp_path / "c1"))
    assert torch.equal(back["model"]["w"], torch.arange(12.0).reshape(3, 4))
    assert torch.equal(back["opt"]["m"], torch.ones((2, 2)))
    assert back["opt"]["@step"] == 7 and back["note"] == "hello"
    assert back["arr"].dtype == torch.int32
    np.testing.assert_array_equal(
        ckpt.load_state_dict(str(tmp_path / "c1"), return_numpy=True)[
            "model"]["w"], np.arange(12.0).reshape(3, 4))


def test_bfloat16_preserved(tmp_path):
    x = torch.arange(8, dtype=torch.bfloat16) / 3
    ckpt.save_state_dict({"x": x}, str(tmp_path / "c"))
    with open(tmp_path / "c" / "meta.json") as f:
        assert json.load(f)["leaves"][0]["dtype"] == "bfloat16"
    stored = np.load(tmp_path / "c" / "shards" / _leaf_file(tmp_path / "c"))
    assert stored.dtype == np.uint16
    np.testing.assert_array_equal(stored, x.view(torch.int16).numpy().view(
        np.uint16))
    back = ckpt.load_state_dict(str(tmp_path / "c"))["x"]
    assert back.dtype == torch.bfloat16 and torch.equal(back, x)


def test_region_load_reads_only_the_block(tmp_path):
    """`shardings` maps a leaf to the region this rank needs."""
    w = torch.arange(64.0).reshape(8, 8)
    ckpt.save_state_dict({"w": w}, str(tmp_path / "c"))
    part = ckpt.load_state_dict(str(tmp_path / "c"),
                                shardings={"w": (slice(4, 8), slice(None))})
    assert torch.equal(part["w"], w[4:])


def test_local_shard_records_its_index(tmp_path):
    block = torch.arange(8.0).reshape(2, 4)
    ckpt.save_state_dict(
        {"w": ckpt.LocalShard(block, (6, 4), [[2, 4], [0, 4]])},
        str(tmp_path / "c"))
    with open(tmp_path / "c" / "meta.json") as f:
        (entry,) = json.load(f)["leaves"]
    assert entry["shape"] == [6, 4]
    assert entry["shards"][0]["index"] == [[2, 4], [0, 4]]
    assert entry["shards"][0]["file"].endswith("#r0s0.npy")
    part = ckpt.load_state_dict(str(tmp_path / "c"), shardings={
        "w": (slice(2, 4), slice(0, 4))})
    assert torch.equal(part["w"], block)


def test_lists_and_bytes_roundtrip(tmp_path):
    state = {"milestones": [2, 4, 8], "blob": b"\x00\xff\x10",
             "nested": {"vals": [0.1, 0.2]}}
    ckpt.save_state_dict(state, str(tmp_path / "c"))
    back = ckpt.load_state_dict(str(tmp_path / "c"))
    assert back["milestones"] == [2, 4, 8]
    assert back["blob"] == b"\x00\xff\x10"
    assert back["nested"]["vals"] == [0.1, 0.2]


def test_empty_containers_np_scalars_and_bad_keys(tmp_path):
    state = {"empty_d": {}, "empty_l": [], "best": np.float32(0.42),
             "n": np.int64(3)}
    ckpt.save_state_dict(state, str(tmp_path / "c"))
    back = ckpt.load_state_dict(str(tmp_path / "c"))
    assert back["empty_d"] == {} and back["empty_l"] == []
    assert abs(back["best"] - 0.42) < 1e-6 and back["n"] == 3
    with pytest.raises(ValueError, match="separator"):
        ckpt.save_state_dict({"a/b": 1}, str(tmp_path / "bad"))


def test_async_save_and_atomicity(tmp_path):
    h = ckpt.save_state_dict({"w": torch.ones((128, 128))},
                             str(tmp_path / "c"), async_save=True)
    h.result()
    assert ckpt.is_complete(str(tmp_path / "c"))
    os.makedirs(tmp_path / "dead.tmp/shards")
    assert not ckpt.is_complete(str(tmp_path / "dead.tmp"))


def test_snapshot_is_an_owned_copy(tmp_path):
    """The step may overwrite a saved tensor the moment the snapshot
    returns: the commit writes the values at the save."""
    chaos.install({"injectors": [
        {"scope": "ckpt.commit", "kind": "delay", "at": [0],
         "delay_s": 0.3}]})
    try:
        w = torch.zeros(64)
        h = ckpt.save_state_dict({"w": w}, str(tmp_path / "c"),
                                 async_save=True)
        w.add_(1.0)
        h.result()
    finally:
        chaos.clear()
    assert torch.equal(ckpt.load_state_dict(str(tmp_path / "c"))["w"],
                       torch.zeros(64))


# ------------------------------------------------------ train-loop resume

def _adamw(m, sched):
    return AdamW(sched, parameters=m.parameters())


def test_train_kill_resume_matches_uninterrupted(tmp_path):
    m1, xs, ys = _tiny_model_and_data()
    step1 = TrainStep(m1, _loss_fn, _adamw(m1, tlr.StepDecay(1e-2, 2)))
    for _ in range(6):
        l_uninterrupted = float(step1(xs, ys))

    m2, _, _ = _tiny_model_and_data()
    step2 = TrainStep(m2, _loss_fn, _adamw(m2, tlr.StepDecay(1e-2, 2)))
    for _ in range(3):
        step2(xs, ys)
    Checkpointer = ckpt.Checkpointer
    Checkpointer(str(tmp_path / "run"), model=m2, train_step=step2).save(3)

    m3, _, _ = _tiny_model_and_data(seed=123)   # overwritten by restore
    opt3 = _adamw(m3, tlr.StepDecay(1e-2, 2))
    step3 = TrainStep(m3, _loss_fn, opt3)
    cp3 = Checkpointer(str(tmp_path / "run"), model=m3, train_step=step3)
    assert cp3.load_latest() == 3
    assert opt3._step_count == 3
    for _ in range(3):
        l_resumed = float(step3(xs, ys))
    assert l_resumed == l_uninterrupted


def test_eager_optimizer_resume_reinstantiated_model(tmp_path):
    """Eager-step accumulators survive a model rebuild (keyed by the
    structural name, not the optimizer's positional one)."""
    m1, xs, ys = _tiny_model_and_data()
    opt1 = AdamW(tlr.MultiStepDecay(1e-2, milestones=[2, 4]),
                 parameters=m1.parameters())
    for _ in range(3):
        _loss_fn(m1, xs, ys).backward()
        opt1.step()
        opt1.clear_grad()
        opt1._learning_rate.step()
    cp = ckpt.Checkpointer(str(tmp_path / "e"), model=m1, optimizer=opt1)
    cp.save(3)
    with open(tmp_path / "e" / "ckpt-00000003" / "meta.json") as f:
        paths = {e["path"] for e in json.load(f)["leaves"]}
    assert "optimizer/0.weight_moment1" in paths

    m2, _, _ = _tiny_model_and_data(seed=5)
    opt2 = AdamW(tlr.MultiStepDecay(1e-2, milestones=[2, 4]),
                 parameters=m2.parameters())
    cp2 = ckpt.Checkpointer(str(tmp_path / "e"), model=m2, optimizer=opt2)
    assert cp2.load_latest() == 3
    assert opt2._learning_rate.milestones == [2, 4]
    opt2._learning_rate.step()
    for p1, p2 in zip(m1.parameters(), m2.parameters()):
        s1, s2 = opt1._states[id(p1)], opt2._states[id(p2)]
        assert all(torch.equal(s1[k], s2[k]) for k in s1)
        assert s1["moment1"].abs().sum() > 0


def test_restore_into_already_running_step(tmp_path):
    m1, xs, ys = _tiny_model_and_data()
    st1 = TrainStep(m1, _loss_fn, AdamW(1e-2, parameters=m1.parameters()))
    for _ in range(3):
        st1(xs, ys)
    ckpt.Checkpointer(str(tmp_path / "r"), model=m1, train_step=st1).save(3)
    l_ref = float(st1(xs, ys))

    m2, _, _ = _tiny_model_and_data(seed=7)
    st2 = TrainStep(m2, _loss_fn, AdamW(1e-2, parameters=m2.parameters()))
    st2(xs, ys)                      # live accumulators, then restore
    cp2 = ckpt.Checkpointer(str(tmp_path / "r"), model=m2, train_step=st2)
    assert cp2.load_latest() == 3
    assert float(st2(xs, ys)) == l_ref


def test_keep_prunes_old(tmp_path):
    m, _, _ = _tiny_model_and_data()
    opt = SGD(1e-2, parameters=m.parameters())
    cp = ckpt.Checkpointer(str(tmp_path / "p"), model=m, optimizer=opt,
                           keep=2)
    for s in (1, 2, 3, 4):
        cp.save(s)
    assert cp.steps() == [3, 4]


# --------------------------------------- durability + fault injection

def test_meta_integrity_record_written(tmp_path):
    ckpt.save_state_dict({"w": torch.ones((4, 4))}, str(tmp_path / "c"))
    with open(tmp_path / "c" / "meta.json") as f:
        meta = json.load(f)
    integ = meta["integrity"]
    assert integ["leaf_count"] == len(meta["leaves"]) == 1
    (entry,) = meta["leaves"]
    for srec in entry["shards"]:
        assert integ["shards"][srec["file"]] == os.path.getsize(
            tmp_path / "c" / "shards" / srec["file"])


def test_torn_checkpoint_rejected_not_half_loaded(tmp_path):
    ckpt.save_state_dict({"w": torch.arange(16.0)}, str(tmp_path / "c"))
    shard = tmp_path / "c" / "shards" / _leaf_file(tmp_path / "c")
    shard.write_bytes(shard.read_bytes()[:-8])
    with pytest.raises(ValueError, match="torn"):
        ckpt.load_state_dict(str(tmp_path / "c"))
    os.unlink(shard)
    with pytest.raises(ValueError, match="torn"):
        ckpt.load_state_dict(str(tmp_path / "c"))


def test_truncated_meta_json_is_torn_not_crash(tmp_path):
    m, _, _ = _tiny_model_and_data()
    cp = ckpt.Checkpointer(str(tmp_path / "t"), model=m,
                           optimizer=SGD(1e-2, parameters=m.parameters()))
    cp.save(1)
    cp.save(2)
    meta = tmp_path / "t" / "ckpt-00000002" / "meta.json"
    meta.write_bytes(meta.read_bytes()[:17])
    with pytest.raises(ckpt.TornCheckpointError):
        ckpt.verify_integrity(str(tmp_path / "t" / "ckpt-00000002"))
    assert cp.load_latest() == 1


def test_load_latest_falls_back_past_torn_checkpoint(tmp_path):
    m, _, _ = _tiny_model_and_data()
    cp = ckpt.Checkpointer(str(tmp_path / "r"), model=m,
                           optimizer=SGD(1e-2, parameters=m.parameters()))
    cp.save(1)
    cp.save(2)
    d2 = tmp_path / "r" / "ckpt-00000002"
    shard = d2 / "shards" / _leaf_file(d2)
    shard.write_bytes(shard.read_bytes()[:-4])
    resilience.reset()
    assert cp.load_latest() == 1
    assert resilience.events("ckpt_rejected")


def test_commit_protocol_files_and_world_recorded(tmp_path):
    ckpt.save_state_dict({"w": torch.ones((4, 4))}, str(tmp_path / "c"),
                         async_save=True).result()
    with open(tmp_path / "c" / "meta.json") as f:
        meta = json.load(f)
    assert meta["commit"]["world"] == 1
    assert (tmp_path / "c" / "DONE.0").is_file()
    assert not (tmp_path / "c.tmp").exists()
    assert ckpt.is_complete(str(tmp_path / "c"))


def test_missing_done_marker_is_invisible(tmp_path):
    m, _, _ = _tiny_model_and_data()
    cp = ckpt.Checkpointer(str(tmp_path / "m"), model=m,
                           optimizer=SGD(1e-2, parameters=m.parameters()))
    cp.save(1)
    cp.save(2)
    os.unlink(tmp_path / "m" / "ckpt-00000002" / "DONE.0")
    ckpt._complete_seen.discard(str(tmp_path / "m" / "ckpt-00000002"))
    counter = obs_metrics.registry().get(
        "pt_ckpt_incomplete_discarded_total")
    before = counter.value
    assert not ckpt.is_complete(str(tmp_path / "m" / "ckpt-00000002"))
    assert cp.steps() == [1]
    assert cp.load_latest() == 1
    assert counter.value == before + 1


def test_missing_marker_for_other_rank_world(tmp_path):
    ckpt.save_state_dict({"w": torch.ones(3)}, str(tmp_path / "c"))
    meta_p = tmp_path / "c" / "meta.json"
    meta = json.loads(meta_p.read_text())
    meta["commit"]["world"] = 2          # DONE.1 does not exist
    meta_p.write_text(json.dumps(meta))
    assert not ckpt.is_complete(str(tmp_path / "c"))


def test_overlapped_save_returns_before_commit(tmp_path):
    chaos.install({"injectors": [
        {"scope": "ckpt.commit", "kind": "delay", "at": [0],
         "delay_s": 1.0}]})
    try:
        t0 = time.perf_counter()
        h = ckpt.save_state_dict({"w": torch.ones((64, 64))},
                                 str(tmp_path / "c"), async_save=True)
        returned = time.perf_counter() - t0
        assert returned < 0.5, f"snapshot blocked {returned:.2f}s"
        h.result()
    finally:
        chaos.clear()
    assert ckpt.is_complete(str(tmp_path / "c"))
    assert h.committer.seconds >= 1.0 and h.committer.bytes == 64 * 64 * 4


def test_backpressure_joins_inflight_commit(tmp_path):
    resilience.reset()
    chaos.install({"injectors": [
        {"scope": "ckpt.commit", "kind": "delay", "at": [0],
         "delay_s": 0.4}]})
    try:
        h1 = ckpt.save_state_dict({"w": torch.ones(8)},
                                  str(tmp_path / "c1"), async_save=True)
        t0 = time.perf_counter()
        h2 = ckpt.save_state_dict({"w": torch.ones(8)},
                                  str(tmp_path / "c2"), async_save=True)
        waited = time.perf_counter() - t0
        h1.result()
        h2.result()
    finally:
        chaos.clear()
    assert waited >= 0.2, f"second save did not back-pressure ({waited:.2f}s)"
    assert resilience.events("ckpt_backpressure")
    assert ckpt.is_complete(str(tmp_path / "c1"))
    assert ckpt.is_complete(str(tmp_path / "c2"))


def test_chaos_commit_scope_rank_targeting(tmp_path):
    chaos.install({"injectors": [
        {"scope": "ckpt.commit.1", "kind": "error", "at": [0]}]})
    try:
        ckpt.save_state_dict({"w": torch.ones(3)}, str(tmp_path / "a"))
    finally:
        chaos.clear()
    assert ckpt.is_complete(str(tmp_path / "a"))
    chaos.install({"injectors": [
        {"scope": "ckpt.commit.0", "kind": "error", "at": [0]}]})
    try:
        with pytest.raises(OSError):
            ckpt.save_state_dict({"w": torch.ones(3)}, str(tmp_path / "b"))
    finally:
        chaos.clear()
    assert not ckpt.is_complete(str(tmp_path / "b"))
    assert os.path.isdir(tmp_path / "b.tmp")


def test_chaos_snapshot_scope_fires_on_the_step_path(tmp_path):
    chaos.install({"injectors": [
        {"scope": "ckpt.snapshot", "kind": "error", "at": [0]}]})
    try:
        with pytest.raises(OSError):
            ckpt.save_state_dict({"w": torch.ones(3)}, str(tmp_path / "s"),
                                 async_save=True)
    finally:
        chaos.clear()
    assert not ckpt.is_complete(str(tmp_path / "s"))


def test_chaos_kill_window_leaves_only_previous_checkpoint(tmp_path):
    m, _, _ = _tiny_model_and_data()
    cp = ckpt.Checkpointer(str(tmp_path / "k"), model=m,
                           optimizer=SGD(1e-2, parameters=m.parameters()))
    cp.save(1)
    chaos.install({"injectors": [
        {"scope": "ckpt.kill_window", "kind": "error", "at": [0]}]})
    try:
        with pytest.raises(OSError):
            ckpt.save_state_dict({"w": torch.ones(3)},
                                 str(tmp_path / "k" / "ckpt-00000002"))
    finally:
        chaos.clear()
    assert os.path.isdir(tmp_path / "k" / "ckpt-00000002.tmp")
    assert not ckpt.is_complete(str(tmp_path / "k" / "ckpt-00000002"))
    assert cp.steps() == [1]
    assert cp.load_latest() == 1


# ------------------------------------------------- across the packages

def _jax_gpt_run(tmp_path):
    """The reference: gpt_tiny, AdamW(StepDecay), 3 TrainStep steps,
    its Checkpointer's save, then 3 more steps."""
    paddle.seed(40)
    jm = JaxGPT(jax_gpt_tiny())
    opt = paddle.optimizer.AdamW(
        paddle.optimizer.lr.StepDecay(1e-3, step_size=2),
        parameters=jm.parameters())
    step = paddle.jit.TrainStep(jm, lambda m, x: JaxCrit()(m(x), x), opt)
    ids = np.random.default_rng(0).integers(0, 2048, (2, 32))
    t = paddle.to_tensor(ids)
    for _ in range(3):
        step(t)
    jck.Checkpointer(str(tmp_path / "jax"), model=jm,
                     train_step=step).save(3)
    losses = [float(step(t).numpy()) for _ in range(3)]
    params = {k: np.asarray(v._value, np.float32)
              for k, v in jm.state_dict().items()}
    return ids, losses, params


def _port_gpt(seed=9):
    m = GPTForCausalLM(gpt_tiny(), device="cpu", seed=seed)
    opt = AdamW(tlr.StepDecay(1e-3, step_size=2), parameters=m.parameters())
    step = TrainStep(m, lambda mm, x: GPTPretrainingCriterion()(mm(x), x),
                     opt)
    return m, opt, step


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    ids, jlosses, jparams = _jax_gpt_run(tmp_path)
    m, opt, step = _port_gpt()
    cp = ckpt.Checkpointer(str(tmp_path / "jax"), model=m, train_step=step)
    assert cp.load_latest() == 3
    assert opt._step_count == 3
    assert opt._learning_rate.last_epoch == 0   # the reference never steps it
    t = torch.from_numpy(ids)
    tlosses = [float(step(t)) for _ in range(3)]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    for k, v in export_state_dict(m).items():
        np.testing.assert_allclose(v, jparams[k], rtol=0, atol=1e-4,
                                   err_msg=k)


def test_port_checkpoint_reads_back_in_the_reference(tmp_path):
    """The port's TrainStep checkpoint: the reference's load_state_dict
    returns equal arrays, and meta.json has the reference's fields (a
    reference TrainStep checkpoint of the same model beside it)."""
    ids, _, _ = _jax_gpt_run(tmp_path)
    m, opt, step = _port_gpt()
    for _ in range(2):
        step(torch.from_numpy(ids))
    ckpt.Checkpointer(str(tmp_path / "port"), model=m,
                      train_step=step).save(2)
    d = str(tmp_path / "port" / "ckpt-00000002")
    back = jck.load_state_dict(d, return_numpy=True)
    assert back["step"] == 2 and back["optimizer"]["@step"] == 2
    for k, v in export_state_dict(m).items():
        np.testing.assert_array_equal(back["model"][k], v)
    for n, p in m.named_parameters():
        st = opt._states[id(p)]
        for acc, val in st.items():
            np.testing.assert_array_equal(back["train_step_opt"][n][acc],
                                          val.numpy())
    mine = json.load(open(os.path.join(d, "meta.json")))
    ref = json.load(open(tmp_path / "jax" / "ckpt-00000003" / "meta.json"))
    assert set(mine) == set(ref)
    assert set(mine["commit"]) == set(ref["commit"])
    assert set(mine["integrity"]) == set(ref["integrity"])
    assert {e["path"] for e in mine["leaves"]} == \
        {e["path"] for e in ref["leaves"]}
    assert set(mine["scalars"]) == set(ref["scalars"])
    by = {e["path"]: e for e in ref["leaves"]}
    for e in mine["leaves"]:
        assert set(e) == set(by[e["path"]])
        assert (e["shape"], e["dtype"]) == (by[e["path"]]["shape"],
                                            by[e["path"]]["dtype"])
        assert [s["file"] for s in e["shards"]] == \
            [s["file"] for s in by[e["path"]]["shards"]]


def test_jax_bf16_leaf_loads_through_the_uint16_storage(tmp_path):
    x = (jnp.arange(16, dtype=jnp.float32) / 7).astype(jnp.bfloat16)
    jck.save_state_dict({"w": x, "o": jnp.ones(2)}, str(tmp_path / "c"))
    back = ckpt.load_state_dict(str(tmp_path / "c"))
    assert back["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(back["w"].float().numpy(),
                                  np.asarray(x, np.float32))
    # and the other way: the port's bf16 leaf in the reference
    ckpt.save_state_dict({"w": back["w"]}, str(tmp_path / "p"))
    jb = jck.load_state_dict(str(tmp_path / "p"))["w"]._value
    assert jb.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(jb, np.float32),
                                  np.asarray(x, np.float32))


def test_optimizer_state_carried_by_convert_equals_the_checkpoint(tmp_path):
    """The two ways a reference run's state reaches the port agree: its
    checkpoint through the Checkpointer, and its arrays through
    `convert`."""
    paddle.seed(40)
    jm = JaxGPT(jax_gpt_tiny())
    jopt = paddle.optimizer.AdamW(1e-3, parameters=jm.parameters())
    t = paddle.to_tensor(np.random.default_rng(0).integers(0, 2048, (2, 16)))
    for _ in range(2):
        loss = JaxCrit()(jm(t), t)
        loss.backward()
        jopt.step()
        jopt.clear_grad()
    jck.Checkpointer(str(tmp_path / "e"), model=jm, optimizer=jopt).save(2)
    m1, opt1, _ = _port_gpt()
    ckpt.Checkpointer(str(tmp_path / "e"), model=m1,
                      optimizer=opt1).load_latest()
    m2, opt2, _ = _port_gpt(seed=3)
    load_jax_state_dict(m2, {k: np.array(v.numpy())
                             for k, v in jm.state_dict().items()})
    load_jax_optimizer_state(
        opt2, m2, {k: (np.array(v.numpy()) if hasattr(v, "numpy") else v)
                   for k, v in jopt.state_dict().items()},
        [p.name for p in jm.state_dict().values()])
    for (n, p1), (_, p2) in zip(m1.named_parameters(),
                                m2.named_parameters()):
        assert torch.equal(p1, p2), n
        s1, s2 = opt1._states[id(p1)], opt2._states[id(p2)]
        assert all(torch.equal(s1[k], s2[k]) for k in s2), n
