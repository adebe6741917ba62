"""The auto-parallel module (paddle_tpu_torch/distributed/auto_parallel.py)
against the JAX package's, case for case with its
tests/test_auto_parallel.py.

- The annotation surface: `shard_tensor`, `plan_tp` and
  `complete_annotations` make the reference's decisions on the same
  models and meshes; `reshard` cuts this rank's block.
- The cost model and the planner are pure Python over shapes: every
  `CostModel` / `Planner` case gives the reference's numbers and `Plan`
  (mesh, parameter specs, ZeRO, cost to 1e-9 relative) when the port is
  given the reference's `ClusterSpec` (a TPU v5e's). The port's default
  `ClusterSpec` is the H100's.
- The Engine at world 1: fit / evaluate / predict equal to the
  reference's Engine on the same weights and batches (1e-5).
- As two gloo processes (tests/torch_hybrid_worker.py `auto`):
  `auto_mode="full"` on a live mp 2 mesh and with the world laid out
  from the plan, `plan_tp` and a completed partial annotation, each
  realized into this rank's shards; the plans equal the reference's and
  the losses are within 1e-5 of the reference Engine's on its own mp 2
  mesh.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.distributed import auto_parallel as jauto
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.distributed import auto_parallel as tauto
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import SGD, AdamW

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_hybrid_worker as worker  # noqa: E402

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


TOL = 1e-5
REF = tauto.ClusterSpec(*worker.REF_CLUSTER)


@pytest.fixture(autouse=True)
def _reset():
    tmesh.reset_mesh()
    jmesh.reset_mesh()
    yield
    tmesh.reset_mesh()
    jmesh.reset_mesh()


def _specs(plan):
    return {n: tuple(s) for n, s in plan.param_specs.items()}


def _same_plan(got, want):
    assert got.mesh == want.mesh
    assert _specs(got) == _specs(want)
    assert got.zero == want.zero
    assert got.cost == pytest.approx(want.cost, rel=1e-9)
    assert got.per_device_bytes == pytest.approx(want.per_device_bytes,
                                                 rel=1e-9)


def _weights(model):
    return {k: np.array(v.numpy()) for k, v in model.state_dict().items()}


def _ref_mlp():
    paddle.seed(0)
    return jnn.Sequential(jnn.Linear(16, 32), jnn.ReLU(), jnn.Linear(32, 8),
                          jnn.ReLU(), jnn.Linear(8, 4))


class _RefEmbMLP(jnn.Layer):
    def __init__(self):
        super().__init__()
        paddle.seed(0)
        self.emb = jnn.Embedding(32, 8)
        self.l1 = jnn.Linear(8, 16)
        self.l2 = jnn.Linear(16, 16)
        self.l3 = jnn.Linear(16, 8)
        self.l4 = jnn.Linear(8, 4)

    def forward(self, ids):
        h = self.emb(ids).mean(axis=1)
        h = jnn.functional.relu(self.l1(h))
        h = jnn.functional.relu(self.l2(h))
        h = jnn.functional.relu(self.l3(h))
        return self.l4(h)


def _ref_auto_net():
    V, d, nh, ffn = (worker.AUTO[k] for k in ("V", "d", "nh", "ffn"))

    class AutoNet(jnn.Layer):
        def __init__(self):
            super().__init__()
            paddle.seed(0)
            self.emb = jnn.Embedding(V, d)
            self.attn = jnn.MultiHeadAttention(d, nh)
            self.fc1 = jnn.Linear(d, ffn)
            self.fc2 = jnn.Linear(ffn, d)
            self.head = jnn.Linear(d, V)

        def forward(self, ids):
            h = self.emb(ids)
            s = ids.shape[1]
            mask = paddle.to_tensor(np.tril(np.ones((s, s), bool)))
            h = h + self.attn(h, h, h, mask)
            h = h + self.fc2(jnn.functional.relu(self.fc1(h)))
            return self.head(h)

    return AutoNet()


def _ref_lm_loss(out, y):
    return jnn.functional.cross_entropy(
        out.reshape([-1, out.shape[-1]]), y.reshape([-1]))


def _ds(n=32, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 16)).astype(np.float32),
            rng.integers(0, 4, (n,)))


# ---- annotations -------------------------------------------------------

def test_shard_tensor_annotation_and_reshard():
    tmesh.init_mesh(mp=8, world_size=8)
    m = worker.mlp_net()
    tauto.shard_tensor(m[0].weight, shard_spec=[None, "mp"])
    assert m[0].weight._pspec == tmesh.PartitionSpec(None, "mp")
    assert tuple(m[0].weight.shape) == (16, 32)   # cut by the Engine
    tmesh.reset_mesh()
    tmesh.init_mesh(dp=2, mp=4, world_size=8)
    t = torch.ones(8, 16)
    tauto.reshard(t, shard_spec=["dp", "mp"])
    assert tuple(t._pspec) == ("dp", "mp")
    np.testing.assert_array_equal(t.numpy(), np.ones((4, 4)))


def test_plan_tp_megatron_pattern_matches_reference():
    jmesh.init_mesh(dp=2, mp=4)
    tmesh.init_mesh(dp=2, mp=4, world_size=8)
    for pre in (False, True):
        ref, port = _ref_mlp(), worker.mlp_net()
        if pre:   # a pre-annotated weight is left as it is
            jauto.shard_tensor(ref[0].weight, shard_spec=[None, None])
            tauto.shard_tensor(port[0].weight, shard_spec=[None, None])
        jauto.plan_tp(ref)
        tauto.plan_tp(port)
        want = {n: p._pspec for n, p in ref.named_parameters()}
        got = {n: getattr(p, "_pspec", None)
               for n, p in port.named_parameters()}
        assert {n: None if s is None else tuple(s) for n, s in got.items()} \
            == {n: None if s is None else tuple(s) for n, s in want.items()}


def test_completion_decisions_match_reference():
    jmesh.init_mesh(dp=2, mp=4)
    tmesh.init_mesh(dp=2, mp=4, world_size=8)
    ref, port = _RefEmbMLP(), worker.emb_mlp_net()
    for m, auto in ((ref, jauto), (port, tauto)):
        auto.shard_tensor(m.emb.weight, shard_spec=[None, "mp"])
        auto.shard_tensor(m.l2.weight, shard_spec=[None, "mp"])
    want = jauto.complete_annotations(ref)
    got = tauto.complete_annotations(port)
    assert [(n, tuple(s)) for n, s in got] == [(n, tuple(s))
                                               for n, s in want]
    assert len(got) == 3 and getattr(port.l4.weight, "_pspec", None) is None


# ---- the cost model and the planner -------------------------------------

def _big(lib):
    return lib.Sequential(lib.Linear(1024, 4096), lib.ReLU(),
                          lib.Linear(4096, 1024))


def test_cost_model_matches_reference():
    """step_cost / memory_per_device / plan of test_cost_model_placement_
    choice and test_cost_model_zero_adds_gather_cost, number for number;
    a slow interconnect; the port's default cluster is the H100's."""
    cm_r, cm_p = jauto.CostModel(), tauto.CostModel(cluster=REF)
    big_r, big_p = _big(jnn), _big(pnn)
    small_r, small_p = _ref_mlp(), worker.mlp_net()
    cases = [(big_r, big_p, 32768, dict(dp=1)),
             (big_r, big_p, 32768, dict(dp=8)),
             (small_r, small_p, 8, dict(dp=8)),
             (small_r, small_p, 8, dict(dp=1)),
             (small_r, small_p, 8, dict(dp=8, zero=True)),
             (small_r, small_p, 8, dict(dp=2, mp=4))]
    for r, p, bs, kw in cases:
        assert cm_p.step_cost(p, bs, **kw) == pytest.approx(
            cm_r.step_cost(r, bs, **kw), rel=1e-12)
        assert cm_p.memory_per_device(p, **kw) == \
            cm_r.memory_per_device(r, **kw)
    best_r, costs_r = cm_r.plan(small_r, batch_size=8, n_devices=8)
    best_p, costs_p = cm_p.plan(small_p, batch_size=8, n_devices=8)
    assert best_p == best_r == "dp"
    assert costs_p == pytest.approx(costs_r, rel=1e-12)
    cap = cm_r.memory_per_device(small_r, dp=8, zero=False) * 0.5
    cand = [("dp", 8, 1, False), ("dp_zero", 8, 1, True)]
    assert cm_p.plan(small_p, 8, n_devices=8, candidates=cand,
                     hbm_capacity=cap) == cm_r.plan(
        small_r, 8, n_devices=8, candidates=cand, hbm_capacity=cap)
    slow_r = jauto.CostModel(cluster=jauto.ClusterSpec(ici_bandwidth=1e8))
    slow_p = tauto.CostModel(cluster=tauto.ClusterSpec(
        *worker.REF_CLUSTER[:1], ici_bandwidth=1e8,
        hbm_capacity=worker.REF_CLUSTER[2]))
    assert slow_p.step_cost(small_p, 8, dp=8) == pytest.approx(
        slow_r.step_cost(small_r, 8, dp=8), rel=1e-12)
    h100 = tauto.ClusterSpec()
    assert (h100.peak_flops, h100.ici_bandwidth, h100.hbm_capacity) == (
        989e12, 450e9, 80e9)


def _emb_heavy(lib):
    base = jnn.Layer if lib is jnn else torch.nn.Module

    class Net(base):
        def __init__(self):
            super().__init__()
            self.emb = lib.Embedding(200_000, 64)
            self.fc = lib.Linear(64, 4)

    return Net()


def _attn_net(lib, d, nh, ffn=None, V=None, blocks=0, tied=False):
    base = jnn.Layer if lib is jnn else torch.nn.Module

    class Block(base):
        def __init__(self):
            super().__init__()
            self.attn = lib.MultiHeadAttention(d, nh)
            self.fc1 = lib.Linear(d, ffn)
            self.fc2 = lib.Linear(ffn, d)

    class Net(base):
        tie_embeddings = tied

        def __init__(self):
            super().__init__()
            if blocks:
                self.emb = lib.Embedding(V, d)
                for i in range(blocks):
                    setattr(self, f"b{i}", Block())
            else:
                self.attn = lib.MultiHeadAttention(d, nh)
                self.fc = lib.Linear(d, d)

    return Net()


PLANNER_CASES = {
    # the reference test → (a function making the model from a layer
    # library, the plan's keywords)
    "wide_mlp_picks_tp": (lambda lib: lib.Sequential(
        lib.Linear(1024, 8192), lib.ReLU(), lib.Linear(8192, 1024)),
        dict(batch_size=64, n_devices=8)),
    "deep_small_picks_dp": (lambda lib: lib.Sequential(
        *[l for _ in range(10) for l in (lib.Linear(64, 64), lib.ReLU())]),
        dict(batch_size=4096, n_devices=8)),
    "embedding_heavy_shards_table": (
        _emb_heavy, dict(batch_size=32, n_devices=8,
                         hbm_capacity=200_000 * 64 * (2 + 4 + 8) * 0.5)),
    "gpt_tiny_hand_megatron": (
        lambda lib: _attn_net(lib, 256, 8, 1024, 2048, blocks=2, tied=True),
        dict(batch_size=64, n_devices=8, tokens_per_sample=128,
             force_mesh={"dp": 4, "mp": 2})),
    "attention_indivisible_heads": (
        lambda lib: _attn_net(lib, 48, 3),
        dict(batch_size=32, n_devices=8, force_mesh={"dp": 4, "mp": 2})),
    "auto_net_live_mp2": (
        lambda lib: _ref_auto_net() if lib is jnn else worker.auto_net(),
        dict(batch_size=64, force_mesh={"dp": 1, "mp": 2, "sharding": 1},
             allow_zero=False)),
    "auto_net_world2": (
        lambda lib: _ref_auto_net() if lib is jnn else worker.auto_net(),
        dict(batch_size=64, n_devices=2)),
}


@pytest.mark.parametrize("case", sorted(PLANNER_CASES))
def test_planner_matches_reference(case):
    build, kw = PLANNER_CASES[case]
    paddle.seed(0)
    want = jauto.Planner().plan(build(jnn), **kw)
    got = tauto.Planner(tauto.CostModel(cluster=REF)).plan(build(pnn), **kw)
    _same_plan(got, want)


def test_planner_infeasible_raises_as_reference():
    for lib, auto, cm in ((jnn, jauto, None),
                          (pnn, tauto, tauto.CostModel(cluster=REF))):
        with pytest.raises(RuntimeError, match="no placement fits"):
            auto.Planner(cm).plan(lib.Sequential(lib.Linear(64, 64)),
                                  batch_size=8, n_devices=1,
                                  hbm_capacity=10.0)


# ---- the Engine at world 1 -------------------------------------------------

def _port_mlp(ref):
    return worker._loaded(worker.mlp_net(), _weights(ref))


def test_engine_fit_evaluate_predict_at_world_one_match_reference():
    """The reference's test_engine_serial_equivalence (SGD on one whole
    batch) carried to three steps, then evaluate and predict, against the
    reference Engine on its one-device mesh with the same weights."""
    x, y = _ds(32)
    ref = _ref_mlp()
    port = _port_mlp(ref)
    jeng = jauto.Engine(model=ref, loss=jnn.functional.cross_entropy)
    jeng.optimizer = paddle.optimizer.SGD(0.1,
                                          parameters=ref.parameters())
    batch = (paddle.to_tensor(x), paddle.to_tensor(y))
    want = jeng.fit([batch] * 3)
    teng = tauto.Engine(model=port, loss=TF.cross_entropy)
    teng.optimizer = SGD(0.1, parameters=port.parameters())
    tb = (torch.from_numpy(x), torch.from_numpy(y))
    got = teng.fit([tb] * 3)
    np.testing.assert_allclose(got, want, rtol=TOL)
    assert teng.realized == [("Linear", "rep", None)] * 3
    np.testing.assert_allclose(teng.evaluate([tb])["loss"],
                               jeng.evaluate([batch])["loss"], rtol=TOL)
    np.testing.assert_allclose(teng.predict([(tb[0],)])[0].numpy(),
                               jeng.predict([(batch[0],)])[0].numpy(),
                               rtol=TOL, atol=1e-6)


def test_engine_dataset_and_multi_input_predict():
    """A map-style dataset is batched (and shuffled for fit); predict
    feeds every batch element to the model (test_engine_predict_multi_
    input)."""

    class TwoIn(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = pnn.Linear(8, 2)

        def forward(self, a, b):
            return self.fc(a + b)

    class DS2(torch.utils.data.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            return (np.ones(8, np.float32), np.ones(8, np.float32) * 2)

    m = TwoIn()
    torch.nn.init.normal_(m.fc.weight)
    torch.nn.init.zeros_(m.fc.bias)
    eng = tauto.Engine(model=m, loss=TF.cross_entropy)
    preds = eng.predict(DS2(), batch_size=4)
    assert len(preds) == 2 and tuple(preds[0].shape) == (4, 2)
    np.testing.assert_allclose(
        preds[0].numpy(),
        m(torch.ones(4, 8), 2 * torch.ones(4, 8)).detach().numpy(),
        rtol=1e-6)

    class DS(torch.utils.data.Dataset):
        def __init__(self):
            self.x, self.y = _ds(64)

        def __len__(self):
            return len(self.x)

        def __getitem__(self, i):
            return self.x[i], self.y[i]

    from paddle_tpu_torch.core import rng

    rng.seed(0)
    net = _port_mlp(_ref_mlp())
    eng = tauto.Engine(model=net, loss=TF.cross_entropy,
                       optimizer=AdamW(5e-3, parameters=net.parameters()))
    hist = eng.fit(DS(), epochs=2, batch_size=16)
    # 4 shuffled batches an epoch: the second epoch's mean loss is lower
    assert len(hist) == 8 and np.mean(hist[4:]) < np.mean(hist[:4]), hist
    assert np.isfinite(eng.evaluate(DS(), batch_size=8)["loss"])


# ---- two processes ---------------------------------------------------------

@pytest.fixture(scope="module")
def auto_job(tmp_path_factory):
    from test_torch_mp_layers import launch_worker

    out = tmp_path_factory.mktemp("auto")
    rng = np.random.default_rng(5)
    V, bs, s = worker.AUTO["V"], worker.AUTO["batch"], worker.AUTO["seq"]
    a = {}
    for i in range(worker.STEPS):
        a[f"ids{i}"] = rng.integers(0, V, (bs, s))
        a[f"y{i}"] = rng.integers(0, V, (bs, s))
    for k, v in _weights(_ref_auto_net()).items():
        a[f"auto/{k}"] = v
    for k, v in _weights(_ref_mlp()).items():
        a[f"mlp/{k}"] = v
    for k, v in _weights(_RefEmbMLP()).items():
        a[f"emb/{k}"] = v
    a["mlp_x"], a["mlp_y"] = _ds(32)
    a["emb_ids"] = rng.integers(0, 32, (16, 4))
    a["emb_y"] = rng.integers(0, 4, (16,))
    np.savez(out / "auto_inputs.npz", **a)
    launch_worker("auto", out, 2, timeout=300)
    return a, [json.load(open(out / f"auto_r{r}.json")) for r in range(2)]


def _ref_engine(model, loss, opt, batches, batch_size, mode=None):
    """The reference Engine's fit losses on its own mp 2 mesh."""
    jmesh.reset_mesh()
    jmesh.init_mesh(devices=jax.devices()[:2], mp=2)
    st = jauto.Strategy()
    if mode == "full":
        st.auto_mode = "full"
    elif mode == "tp":
        st.tensor_parallel.enable = True
    with jax.default_matmul_precision("highest"):
        eng = jauto.Engine(model=model, loss=loss, optimizer=opt(model),
                           strategy=st)
        hist = eng.fit(batches, batch_size=batch_size)
    jmesh.reset_mesh()
    return hist, eng.plan


def test_full_auto_engine_on_two_processes(auto_job):
    """auto_mode="full" on a live mp 2 mesh: the plan splits the heads,
    fc1, fc2 and the head over mp (the reference's plan); each rank holds
    its shards; the losses are the reference Engine's on its mp 2 mesh.
    With the world laid out from the plan (no mesh), the plan is the
    reference planner's over 2 devices and the losses the same."""
    a, res = auto_job
    batches = [(paddle.to_tensor(a[f"ids{i}"]), paddle.to_tensor(a[f"y{i}"]))
               for i in range(worker.STEPS)]
    want, plan = _ref_engine(
        _ref_auto_net(), _ref_lm_loss,
        lambda m: paddle.optimizer.AdamW(worker.AUTO["lr"],
                                         parameters=m.parameters()),
        batches, worker.AUTO["batch"], mode="full")
    world = jauto.Planner().plan(_ref_auto_net(), worker.AUTO["batch"],
                                 n_devices=2)
    for r in res:
        live = r["full_live"]
        assert live["plan"]["mesh"] == plan.mesh
        assert {n: tuple(s) for n, s in live["plan"]["specs"].items()} == \
            _specs(plan)
        assert live["plan"]["cost"] == pytest.approx(plan.cost, rel=1e-9)
        assert ["Attention", "heads", "mp"] in live["realized"]
        assert live["shapes"]["attn.q_proj.weight"] == [
            worker.AUTO["d"], worker.AUTO["d"] // 2]
        np.testing.assert_allclose(live["losses"], want, rtol=TOL)
        assert np.isfinite(live["eval"]) and np.isfinite(live["pred_sum"])
        w = r["full_world"]
        assert w["plan"]["mesh"] == world.mesh == {"dp": 1, "mp": 2}
        assert {n: tuple(s) for n, s in w["plan"]["specs"].items()} == \
            _specs(world)
        assert w["mesh"]["mp"] == 2
        np.testing.assert_allclose(w["losses"], want, rtol=TOL)


def test_semi_auto_engine_on_two_processes(auto_job):
    """plan_tp (tensor_parallel.enable: column, row, column) and a partial
    annotation completed (a hidden-sharded Embedding, a column Linear, its
    row completion), realized on mp 2: the reference Engine's losses; and
    reshard's round trip."""
    a, res = auto_job
    xy = (paddle.to_tensor(a["mlp_x"]), paddle.to_tensor(a["mlp_y"]))
    ref = _ref_mlp()   # the weights the job loaded (paddle.seed(0))
    want_tp, _ = _ref_engine(
        ref, jnn.functional.cross_entropy,
        lambda m: paddle.optimizer.SGD(0.1, parameters=m.parameters()),
        [xy] * 3, 32, mode="tp")
    emb = _RefEmbMLP()
    jauto.shard_tensor(emb.emb.weight, shard_spec=[None, "mp"])
    jauto.shard_tensor(emb.l2.weight, shard_spec=[None, "mp"])
    ids = (paddle.to_tensor(a["emb_ids"]), paddle.to_tensor(a["emb_y"]))
    want_c, _ = _ref_engine(
        emb, jnn.functional.cross_entropy,
        lambda m: paddle.optimizer.SGD(0.1, parameters=m.parameters()),
        [ids] * 5, 16)
    for rank, r in enumerate(res):
        np.testing.assert_allclose(r["plan_tp"]["losses"], want_tp,
                                   rtol=TOL)
        assert [u[1] for u in r["plan_tp"]["realized"]] == ["col", "row",
                                                            "col"]
        np.testing.assert_allclose(r["completion"]["losses"], want_c,
                                   rtol=TOL)
        assert [u[1] for u in r["completion"]["realized"]] == [
            "hidden", "row", "col", "row", "rep"]
        whole = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
        np.testing.assert_array_equal(r["reshard"]["block"],
                                      whole[:, rank * 8:(rank + 1) * 8])
        assert r["reshard"]["spec"] == [None, "mp"]
        np.testing.assert_array_equal(r["reshard"]["whole"], whole)
