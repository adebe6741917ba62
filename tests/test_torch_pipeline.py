"""Pipeline parallelism across processes (paddle_tpu_torch/distributed/
fleet/meta_parallel/pipeline_1f1b.py, pipeline_parallel.py,
pp_layers.py, hybrid3d/schedule.py, jit/hybrid_step.py and the pipelined
GPT) against the JAX package's.

The pure pieces — `schedule_ticks`, `interleaved_stacking_order` and
`gpipe_ticks` — equal the reference's over a grid of (M, pp, V), and
every stage's row of the port's tick table keeps the reference's
lockstep formulas.

One launched gloo job of 4 processes (tests/torch_hybrid_worker.py
`hybrid`) takes the reference's PipelinedGPTForCausalLM weights (vocab
256, hidden 64, 4 layers, 4 heads, seq 32, batch 8, n_micro 4, AdamW
1e-3) and runs, each rank on its shard: the gradients of one loss at pp
2 × mp 2; three HybridTrainStep steps at pp 2 × mp 2 under 1F1B,
GPipe, interleaved n_virtual=2 and remat="layer"; the forward-only
(no-grad) loss; three steps at dp 2 × pp 2 with ZeRO os over dp; a
checkpoint of the pp 2 × mp 2 run; and a PipelineLayer with a tied
SharedLayerDesc under `PipelineParallel.train_batch`. Each is held
against the reference: its HybridTrainStep on a pp 2 × mp 2 CPU mesh
and its serial run (which the reference's own tests hold its hybrid
meshes to), at the reference's tolerance for those trajectories, 2e-4
relative (its test_hybrid_pp_mp.py); gradients 1e-4 of each array's
max-abs (summation order across shards), final parameters 1e-4
absolute (Adam's normalisation of small gradient elements, as in
test_torch_parallel_step).
"""
import json
import os
import sys

import numpy as np
import pytest

import jax

import paddle_tpu as paddle
from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.distributed import hybrid3d as jh3d
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed.fleet.meta_parallel import (
    interleaved_stacking_order as j_order, schedule_ticks as j_ticks)
from paddle_tpu.text.models.gpt import GPTConfig as JaxCfg
from paddle_tpu.text.models.gpt_pipeline import (
    PipelinedGPTForCausalLM as JaxPipe)
from paddle_tpu_torch.convert import gather_pipelined_state
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.distributed.checkpoint import Checkpointer
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    interleaved_stacking_order, schedule_ticks)
from paddle_tpu_torch.distributed.fleet.meta_parallel.pipeline_1f1b import (
    schedule_table)
from paddle_tpu_torch.distributed.hybrid3d import gpipe_ticks
from paddle_tpu_torch.distributed.hybrid3d.schedule import gpipe_table
from paddle_tpu_torch.jit import HybridTrainStep
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.text.models.gpt_pipeline import (
    PipelinedGPTForCausalLM)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_hybrid_worker as worker  # noqa: E402
from test_torch_mp_layers import launch_worker  # noqa: E402

pytestmark = pytest.mark.torch_port

TRAJ_RTOL = 2e-4
ARRAY_TOL = 1e-4


# ---- the pure schedules ------------------------------------------------

GRID = [(M, pp, V) for M in (1, 2, 3, 4, 6, 7, 8) for pp in (1, 2, 3, 4)
        for V in (1, 2, 3)]


@pytest.mark.parametrize("M,pp,V", GRID)
def test_schedule_ticks_and_stacking_order_match_reference(M, pp, V):
    assert schedule_ticks(M, pp, V) == j_ticks(M, pp, V)
    assert interleaved_stacking_order(pp, V) == j_order(pp, V)
    assert gpipe_ticks(M, pp) == jh3d.gpipe_ticks(M, pp)


@pytest.mark.parametrize("M,pp,V", [(4, 2, 1), (7, 3, 1), (8, 2, 2),
                                    (4, 4, 3), (6, 2, 3)])
def test_tick_table_keeps_the_reference_formulas(M, pp, V):
    """Every stage's row: forward of unit u = q·V·pp + v·pp + r at tick
    u + s, backward at (V·pp−1) + β + (pp−1) − s, each (micro, chunk)
    exactly once each way; a stage's backward of a unit comes after its
    forward; the next logical stage forwards a unit one tick after its
    predecessor and backwards it one tick before."""
    table = schedule_table(M, pp, V)
    T = schedule_ticks(M, pp, V)
    units = {(m, v) for m in range(M) for v in range(V)}
    fwd_at, bwd_at = {}, {}
    for s, rows in enumerate(table):
        assert [t for t, _, _ in rows] == list(range(T))
        f = [(u, t) for t, u, _ in rows if u is not None]
        b = [(u, t) for t, _, u in rows if u is not None]
        assert {u for u, _ in f} == units and len(f) == len(units)
        assert {u for u, _ in b} == units and len(b) == len(units)
        for (m, v), t in f:
            q, r = divmod(m, pp)
            assert t == q * V * pp + v * pp + r + s
            fwd_at[(s, m, v)] = t
        for (m, v), t in b:
            q, r = divmod(m, pp)
            beta = q * V * pp + (V - 1 - v) * pp + r
            assert t == (V * pp - 1) + beta + (pp - 1) - s
            bwd_at[(s, m, v)] = t
    for (s, m, v), t in fwd_at.items():
        assert bwd_at[(s, m, v)] >= t
        nxt = (s + 1, v) if s < pp - 1 else (0, v + 1)
        if nxt[1] < V:
            assert fwd_at[(nxt[0], m, nxt[1])] == t + 1
            assert bwd_at[(nxt[0], m, nxt[1])] == bwd_at[(s, m, v)] - 1
    g = gpipe_table(M, pp)
    assert len(g[0]) == gpipe_ticks(M, pp)


# ---- the launched job --------------------------------------------------

def _jcfg():
    return JaxCfg(**worker.CFG)


def _ids():
    return np.random.default_rng(1).integers(
        0, worker.CFG["vocab_size"], (8, worker.CFG["max_seq_len"]))


def _ref_run(mesh_kw, ids, steps=worker.STEPS, hybrid=False):
    """The reference's trajectory (and final parameters) from seed 0."""
    jmesh.reset_mesh()
    if mesh_kw is None:
        jmesh.init_mesh(devices=jax.devices()[:1])
    else:
        jmesh.init_mesh(devices=jax.devices()[:4], **mesh_kw)
    try:
        with jax.default_matmul_precision("highest"):
            paddle.seed(0)
            m = JaxPipe(_jcfg(), n_micro=worker.N_MICRO)
            opt = paddle.optimizer.AdamW(worker.LR,
                                         parameters=m.parameters())
            cls = jh3d.HybridTrainStep if hybrid else paddle.jit.TrainStep
            step = cls(m, lambda mm, i: mm.loss(i), opt)
            t = paddle.to_tensor(ids)
            losses = [float(step(t).numpy()) for _ in range(steps)]
            params = {k: np.asarray(v._value, np.float32)
                      for k, v in m.state_dict().items()}
        return losses, params
    finally:
        jmesh.reset_mesh()


def _ref_weights_and_grads(ids):
    jmesh.reset_mesh()
    jmesh.init_mesh(devices=jax.devices()[:1])
    try:
        with jax.default_matmul_precision("highest"):
            paddle.seed(0)
            m = JaxPipe(_jcfg(), n_micro=worker.N_MICRO)
            w = {k: np.array(v.numpy()) for k, v in m.state_dict().items()}
            m.loss(paddle.to_tensor(ids)).backward()
            g = {n: np.asarray(p.grad.numpy()) for n, p in
                 m.named_parameters() if p.grad is not None}
        return w, g
    finally:
        jmesh.reset_mesh()


@pytest.fixture(scope="module")
def hybrid_job(tmp_path_factory):
    out = tmp_path_factory.mktemp("hybrid")
    ids = _ids()
    w, grads = _ref_weights_and_grads(ids)
    np.savez(out / "pipe_weights.npz", **w)
    np.save(out / "pipe_ids.npy", ids)
    launch_worker("hybrid", out, 4)
    res = [json.load(open(out / f"hybrid_r{r}.json")) for r in range(4)]
    serial, serial_params = _ref_run(None, ids)
    hybrid, _ = _ref_run({"pp": 2, "mp": 2}, ids, hybrid=True)
    return dict(out=out, ids=ids, w=w, grads=grads, res=res,
                serial=serial, serial_params=serial_params, hybrid=hybrid)


def _gather(out, prefix, res, mesh_key="pp2mp2", mp=2, n_virtual=1):
    """{name: logical array} from the ranks' npz files (dp rank 0)."""
    shards = {}
    for r, o in enumerate(res):
        dp, pp_, mp_ = o[f"{mesh_key}/coord"]
        if dp == 0:
            shards[(pp_, mp_)] = dict(np.load(out / f"{prefix}_r{r}.npz"))
    return gather_pipelined_state(shards, JaxCfg(**worker.CFG), pp=2,
                                  mp=mp, n_virtual=n_virtual)


def _close_arrays(got, want, names, absolute=False):
    """Each array within ARRAY_TOL of its max-abs (gradients), or within
    ARRAY_TOL absolute (parameters after AdamW steps: Adam normalises
    each update to about lr = 1e-3, so summation noise in a small
    gradient element becomes a step of that size)."""
    for n in names:
        g, w_ = np.asarray(got[n]), np.asarray(want[n])
        scale = 1.0 if absolute else max(float(np.abs(w_).max()), 1e-12)
        assert float(np.abs(g - w_).max()) <= ARRAY_TOL * scale, n


def test_pp2_mp2_loss_gradients_equal_reference(hybrid_job):
    """One loss at the reference's weights through 1F1B at pp 2 × mp 2:
    every logical gradient (gathered from the ranks' shards, the tied
    wte's summed over its two stages) equals the reference's."""
    j = hybrid_job
    shards = {}
    for r, o in enumerate(j["res"]):
        _, pp_, mp_ = o["pp2mp2/coord"]
        shards[(pp_, mp_)] = dict(np.load(j["out"] / f"grads_r{r}.npz"))
    got = gather_pipelined_state(shards, JaxCfg(**worker.CFG), 2, 2)
    _close_arrays(got, j["grads"], sorted(j["grads"]))


@pytest.mark.parametrize("name", ["pp2mp2", "gpipe", "v2", "layer",
                                  "dp2pp2_zero_os", "pp2_storage"])
def test_hybrid_trajectories_equal_reference(hybrid_job, name):
    """HybridTrainStep over 3 steps on every rank: the reference's
    HybridTrainStep at pp 2 × mp 2 and its serial run."""
    j = hybrid_job
    np.testing.assert_allclose(j["hybrid"], j["serial"], rtol=TRAJ_RTOL)
    for o in j["res"]:
        np.testing.assert_allclose(o[f"{name}/losses"], j["hybrid"],
                                   rtol=TRAJ_RTOL, err_msg=name)
    if name != "dp2pp2_zero_os":
        got = _gather(j["out"], f"{name}_params", j["res"], name,
                      mp=1 if name == "pp2_storage" else 2,
                      n_virtual=2 if name == "v2" else 1)
        _close_arrays(got, j["serial_params"],
                      [n for n in j["serial_params"] if n != "aux_loss"],
                      absolute=True)


def test_executed_schedule_is_the_table(hybrid_job):
    """Each rank ran its stage's row of schedule_table(4, 2): the same
    (tick, micro) work in the same order, schedule_ticks(4, 2) ticks."""
    for o in hybrid_job["res"]:
        _, stage, _ = o["pp2mp2/coord"]
        want = []
        for t, f, b in schedule_table(4, 2)[stage]:
            if f is not None:
                want.append([str(t), "F", str(f[0]), str(f[1])])
            if b is not None:
                want.append([str(t), "B", str(b[0]), str(b[1])])
        assert o["pp2mp2/schedule"] == want
        assert int(want[-1][0]) < schedule_ticks(4, 2)


def test_comm_counters_and_tied_wte(hybrid_job):
    """The handoffs went over p2p (4 micro-batches each way a step, one
    [2, 32, 64] f32 activation or cotangent each), the mp all-reduces
    ran, and the tied wte's gradient was summed over the stage pair once
    a step on stages 0 and 1."""
    for o in hybrid_job["res"]:
        assert o["pp2mp2/p2p"]["p2p_send"]["calls"] == 4 * worker.STEPS
        assert o["pp2mp2/p2p"]["p2p_send"]["bytes"] == \
            4 * worker.STEPS * 2 * 32 * 64 * 4
        assert o["pp2mp2/mp"]["allreduce"]["calls"] > 0
        assert o["pp2mp2/tied"]["calls"] == worker.STEPS
        assert o["pp2mp2/tied"]["bytes"] == worker.STEPS * 128 * 64 * 4


def test_eval_forward_only_loss(hybrid_job):
    """The no-grad loss (the fill-drain) equals the 1F1B one."""
    for o in hybrid_job["res"]:
        np.testing.assert_allclose(o["eval/no_grad_loss"],
                                   o["eval/grad_loss"], rtol=1e-6)
        np.testing.assert_allclose(o["eval/grad_loss"],
                                   hybrid_job["hybrid"][0], rtol=TRAJ_RTOL)


def test_shard_storage_keeps_parameter_blocks(hybrid_job):
    """shard_storage() on a pp 2 × sharding 2 mesh: between steps each
    rank's parameters hold its block over 'sharding' (the stage's qkv
    rows [2, 64, 192] halved on their largest dim)."""
    for o in hybrid_job["res"]:
        shapes = o["pp2_storage/block_shapes"]
        assert shapes["stk_qkv_w"] == [2, 64, 96]
        assert shapes["stk_fc1_w"] == [2, 64, 128]


def test_zero_os_moments_shard_over_dp(hybrid_job):
    """ZeRO os over dp at dp 2 × pp 2: each rank's Adam moments hold its
    dp block of its stage's rows (wte's vocab rows halved)."""
    shapes = hybrid_job["res"][0]["dp2pp2_zero_os/moment_shapes"]
    assert "(128, 64)" in shapes and "(256, 64)" not in shapes


def test_pp_mp_checkpoint_loads_at_world_one(hybrid_job):
    """The pp 2 × mp 2 run's checkpoint (each rank its shards, in logical
    coordinates): a world-1 port model and the reference's own
    load_state_dict read the same logical parameters, equal to the
    ranks' gathered ones."""
    j = hybrid_job
    want = _gather(j["out"], "pp2mp2_params", j["res"])
    root = str(j["out"] / "ckpt")
    tmesh.reset_mesh()
    m = PipelinedGPTForCausalLM(JaxCfg(**worker.CFG), n_micro=4,
                                device="cpu")
    step = HybridTrainStep(m, lambda mm, i: mm.loss(i),
                           AdamW(1e-3, parameters=m.parameters()))
    assert Checkpointer(root, model=m, train_step=step).load_latest() == 3
    got = {n: p.detach().numpy() for n, p in m.named_parameters()}
    for n, a in want.items():
        np.testing.assert_array_equal(got[n], a, err_msg=n)
    ref = jckpt.load_state_dict(os.path.join(root, "ckpt-00000003"),
                                return_numpy=True)
    for n, a in want.items():
        np.testing.assert_array_equal(np.asarray(ref["model"][n]), a,
                                      err_msg=n)
    # the moments came back too, on the world-1 shapes
    st = step.optimizer._states[id(m.stk_qkv_w)]
    assert tuple(st["moment1"].shape) == (4, 64, 192)


def test_pipeline_layer_train_batch_matches_one_process(hybrid_job):
    """A PipelineLayer (tied embedding / head SharedLayerDesc, two
    Linears) under PipelineParallel.train_batch across 2 stages: its
    losses and every parameter equal the same stack's in one process."""
    tmesh.reset_mesh()
    losses, ev, params = worker.pipeline_layer_run()
    for o in hybrid_job["res"]:
        np.testing.assert_allclose(o["pplayer/losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(o["pplayer/eval"], ev, rtol=1e-5)
        for n, v in o["pplayer/params"].items():
            key = "0.weight" if n == "3.layer.weight" else n
            np.testing.assert_allclose(np.asarray(v), params[key],
                                       rtol=1e-5, atol=1e-6, err_msg=n)


def _generic_reference():
    """The reference's functional pipeline over the serial stack: the
    loss of `test_pipeline_1f1b`'s tanh blocks and head, its gradients,
    and the fill-drain outputs and their gradients under a fixed
    cotangent."""
    import jax.numpy as jnp

    from paddle_tpu.distributed.fleet.meta_parallel.pipeline_1f1b import (
        pipeline_1f1b as jpipe)

    a = worker.generic_inputs()

    def run(W, x):
        for i in range(W.shape[0]):
            x = jnp.tanh(x @ W[i])
        return x

    def head(y, labels, wh):
        lp = jax.nn.log_softmax(y @ wh, -1)
        return -jnp.mean(jnp.take_along_axis(lp, labels[..., None], -1))

    def block(W, x):
        out, _ = jax.lax.scan(lambda h, w: (jnp.tanh(h @ w), None), x, W)
        return out

    jmesh.reset_mesh()
    jmesh.init_mesh(devices=jax.devices()[:1])
    try:
        with jax.default_matmul_precision("highest"):
            ys = jnp.asarray(a["ys"])
            loss, grads = jax.value_and_grad(
                lambda W, wh, xs: jpipe(block, head, W, wh, (xs, ys)),
                argnums=(0, 1, 2))(jnp.asarray(a["W"]), jnp.asarray(a["Wh"]),
                                   jnp.asarray(a["xs"]))
            outs = jax.vmap(lambda x: run(jnp.asarray(a["W"]), x))(
                jnp.asarray(a["xs"]))
            g_out = jax.grad(lambda W, xs: jnp.sum(jax.vmap(
                lambda x: run(W, x))(xs) * a["G"]), argnums=(0, 1))(
                jnp.asarray(a["W"]), jnp.asarray(a["xs"]))
            logits = outs.reshape(12, 8)[:11] @ a["Wh"]
    finally:
        jmesh.reset_mesh()
    return (float(loss), [np.asarray(g) for g in grads], np.asarray(outs),
            [np.asarray(g) for g in g_out], np.asarray(logits))


def _generic_aux_reference():
    """The reference's pipeline_1f1b with aux_weight 0.1 over the serial
    stack, each layer adding mean(y²) to the aux: ((loss + 0.1·aux,
    aux), its gradients)."""
    import jax.numpy as jnp

    from paddle_tpu.distributed.fleet.meta_parallel.pipeline_1f1b import (
        pipeline_1f1b as jpipe)

    a = worker.generic_inputs()

    def head(y, labels, wh):
        lp = jax.nn.log_softmax(y @ wh, -1)
        return -jnp.mean(jnp.take_along_axis(lp, labels[..., None], -1))

    def block(W, x):
        def body(h, w):
            h = jnp.tanh(h @ w)
            return h, jnp.mean(h * h)
        out, auxs = jax.lax.scan(body, x, W)
        return out, jnp.sum(auxs)

    jmesh.reset_mesh()
    jmesh.init_mesh(devices=jax.devices()[:1])
    try:
        with jax.default_matmul_precision("highest"):
            ys = jnp.asarray(a["ys"])
            (loss, aux), grads = jax.value_and_grad(
                lambda W, wh, xs: jpipe(block, head, W, wh, (xs, ys),
                                        aux_weight=0.1),
                argnums=(0, 1, 2), has_aux=True)(
                    jnp.asarray(a["W"]), jnp.asarray(a["Wh"]),
                    jnp.asarray(a["xs"]))
    finally:
        jmesh.reset_mesh()
    return (float(loss), float(aux)), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", ["1f1b", "gpipe", "interleaved", "dp",
                                  "aux", "dp_aux"])
def test_functional_pipelines_match_reference(hybrid_job, name):
    """pipeline_1f1b (stage remat), pipeline_gpipe and
    interleaved_pipeline_loss (V 2, round-robin chunks, no remat) over a
    plain tanh stack at pp 2: the loss on every stage, each stage's layer
    gradients, the head's gradient on the last stage and the input
    cotangents on stage 0 equal the reference's pipeline_1f1b (its
    serial path) on the whole stack. "dp": 1F1B with
    PipelineSpecs(dp_axis="dp"), each dp rank on its row of every
    micro-batch: the global loss and gradients, and each rank's rows of
    the input cotangent. "aux" / "dp_aux": the same with the aux channel
    (aux_weight 0.1, each layer adding mean(y²), over dp its global
    value): the pair (loss + 0.1·aux, aux) and the gradients of the
    reference's pipeline_1f1b with aux_weight."""
    if name in ("aux", "dp_aux"):
        (loss, aux), (dW, dWh, dX) = _generic_aux_reference()
    else:
        loss, (dW, dWh, dX), _, _, _ = _generic_reference()
    for o in hybrid_job["res"]:
        dp, stage, _ = o["dp2pp2_zero_os/coord"]
        if name in ("aux", "dp_aux"):
            np.testing.assert_allclose(o[f"gen/{name}/aux"], aux,
                                       rtol=1e-5)
        if name in ("dp", "dp_aux"):
            dX_ = dX[:, dp:dp + 1]
        else:
            dX_ = dX
        rows = [2 * stage, 2 * stage + 1] if name != "interleaved" else \
            [stage, stage + 2]
        np.testing.assert_allclose(o[f"gen/{name}/loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(o[f"gen/{name}/dw"], dW[rows],
                                   rtol=1e-4, atol=1e-6)
        if stage == 1:
            np.testing.assert_allclose(o[f"gen/{name}/dwh"], dWh,
                                       rtol=1e-4, atol=1e-6)
        else:
            assert o[f"gen/{name}/dwh"] is None
            np.testing.assert_allclose(o[f"gen/{name}/dx"], dX_,
                                       rtol=1e-4, atol=1e-6)


def test_quant_dp_pipeline_within_the_int8_bound(hybrid_job):
    """PipelineSpecs(dp_axis="dp", quant_dp=True): the loss exact, each
    stage's gradients within the int8 exchange's bound of the exact mean
    (two roundings of a block's absmax / 127) and equal on both dp
    ranks; the input cotangents exact."""
    loss, (dW, dWh, dX), _, _, _ = _generic_reference()
    got = {}
    for o in hybrid_job["res"]:
        dp, stage, _ = o["dp2pp2_zero_os/coord"]
        np.testing.assert_allclose(o["gen/dp_quant/loss"], loss, rtol=1e-5)
        dw = np.asarray(o["gen/dp_quant/dw"])
        want = dW[[2 * stage, 2 * stage + 1]]
        assert np.abs(dw - want).max() <= 2 * np.abs(want).max() / 127
        got.setdefault(stage, []).append(dw)
        if stage == 0:
            np.testing.assert_allclose(o["gen/dp_quant/dx"],
                                       dX[:, dp:dp + 1], rtol=1e-4,
                                       atol=1e-6)
    for stage, dws in got.items():
        np.testing.assert_array_equal(dws[0], dws[1])


def test_spmd_pipeline_and_inference_helper(hybrid_job):
    """spmd_pipeline's fill-drain: the last stage's outputs on every
    stage, each stage's gradients and the input cotangent under a fixed
    output cotangent; HybridParallelInferenceHelper's pipelined forward
    (micro-batches of 4 rows, the 11-row batch padded) through the head."""
    _, _, outs, (gW, gX), logits = _generic_reference()
    for o in hybrid_job["res"]:
        _, stage, _ = o["dp2pp2_zero_os/coord"]
        np.testing.assert_allclose(o["gen/spmd/out"], outs, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(o["gen/spmd/dw"],
                                   gW[[2 * stage, 2 * stage + 1]],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(o["gen/spmd/dx"], gX, rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(o["gen/infer"], logits, rtol=1e-5,
                                   atol=1e-6)
