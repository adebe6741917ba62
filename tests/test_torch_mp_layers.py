"""Megatron tensor parallelism (paddle_tpu_torch/distributed/fleet/
meta_parallel/mp_layers.py, mp_ops.py, fleet.TensorParallel,
distributed.split, hybrid3d/tp.py and quantize_model_int8(tp_shard))
against the JAX package's.

One launched gloo job of 2 processes on an mp 2 mesh
(tests/torch_hybrid_worker.py `mp`) holds this rank's shard of each
whole weight (numpy, from a seed) and runs each layer forward and
backward: ColumnParallelLinear (gather_output both ways),
RowParallelLinear (input_is_parallel both ways), VocabParallelEmbedding,
ParallelCrossEntropy with an ignored position, a column → row MLP whose
input gradient must equal the serial one (the copy_to_mp / allreduce_mp
pairing: a plain all-reduce would double it), the flat GPT from the
reference's weights with its per-head qkv shard, `split`, the int8
placements and TensorParallel's broadcast. Outputs and gradients are
held against the reference's serial layers (its mp layers hold whole
weights; on a 1-device mesh they are plain linears) over the same
numpy inputs.

Tolerances: 1e-5 relative / 1e-6 absolute for f32 layers (the two
ranks' partial sums are added in another order than one matmul's);
the GPT loss and logits 1e-5; int8 outputs 1e-5 against the reference's
quantized model where the codes and the activation quantization are
the same (column placement), 2e-2 for the row placement (the port
quantizes each rank's slice of the activation row, the reference the
whole row).
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.text.models import GPTForCausalLM as JaxGPT
from paddle_tpu.text.models.gpt import GPTConfig as JaxCfg
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    mp_layers as tmpu)

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


RTOL, ATOL = 1e-5, 1e-6


def launch_worker(mode, out, nproc, timeout=240):
    """tests/torch_hybrid_worker.py `mode` under the port's launcher in a
    session of its own, at a lower CPU priority (its 2-8 processes must
    not starve timing-sensitive tests running beside it); on failure,
    the ranks' log tails."""
    import signal
    import subprocess

    import test_torch_parallel_step as tps

    script = os.path.join(tps.ROOT, "tests", "torch_hybrid_worker.py")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           f"--nproc_per_node={nproc}", f"--log_dir={out}/log", script,
           mode, str(out)]
    p = subprocess.Popen(cmd, env=tps._env(), cwd=tps.ROOT,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, start_new_session=True,
                         preexec_fn=lambda: os.nice(10))
    try:
        so, se = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGTERM)
        so, se = p.communicate(timeout=30)
        pytest.fail(f"launch {mode} timed out after {timeout} s\n{so}\n{se}")
    if p.returncode != 0:
        logs = ""
        for r in range(nproc):
            f = os.path.join(str(out), "log", f"default.rank{r}.log")
            if os.path.exists(f):
                logs += f"--- rank {r} ---\n" + open(f).read()[-3000:]
        pytest.fail(f"launch {mode} exited {p.returncode}\n{so}\n{se}\n"
                    f"{logs}")
    return p.returncode


def mp_inputs():
    rng = np.random.default_rng(11)

    def f(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    logits = f(6, 16)
    labels = rng.integers(0, 16, (6,)).astype(np.int64)
    labels[2] = -100
    return dict(
        x=f(4, 8), gy=f(4, 6), w=f(8, 6, scale=0.3), b=f(6),
        x6=f(4, 6), gy8=f(4, 8), w_row=f(6, 8, scale=0.3), b8=f(8),
        emb=f(16, 4), ids=rng.integers(0, 16, (3, 5)).astype(np.int64),
        gy_emb=f(3, 5, 4), logits=logits, labels=labels,
        w1=f(8, 16, scale=0.3), b1=f(16), w2=f(16, 8, scale=0.3), b2=f(8),
        gy_mlp=f(4, 8),
        q_w1=f(16, 32, scale=0.2), q_b1=f(32), q_w2=f(32, 8, scale=0.2),
        q_b2=f(8), q_x=f(4, 16), q_w3=f(32, 5, scale=0.2), q_b3=f(5),
        q_x32=f(4, 32))


def gpt_reference():
    """The reference flat GPT (the workers' config) from seed 0 and a
    seeded batch: (weights, ids)."""
    jmesh.reset_mesh()
    paddle.seed(0)
    jm = JaxGPT(JaxCfg(**worker.CFG))
    w = {k: np.array(v.numpy()) for k, v in jm.state_dict().items()}
    ids = np.random.default_rng(3).integers(0, 256, (2, 16)).astype(
        np.int64)
    return w, ids


@pytest.fixture(scope="module")
def mp_job(tmp_path_factory):
    out = tmp_path_factory.mktemp("mp")
    a = mp_inputs()
    np.savez(out / "mp_inputs.npz", **a)
    w, ids = gpt_reference()
    np.savez(out / "gpt_weights.npz", **w)
    np.save(out / "gpt_ids.npy", ids)
    launch_worker("mp", out, 2)
    res = [dict(np.load(out / f"mp_r{r}.npz")) for r in range(2)]
    return a, (w, ids), res


# ---- the reference's serial layers -------------------------------------

def _j(x):
    return jnp.asarray(x)


def _linear_ref(x, w, b, gy):
    def f(x, w, b):
        return jnp.sum((x @ w + b) * gy)

    y = x @ w + b
    dx, dw, db = jax.grad(f, argnums=(0, 1, 2))(_j(x), _j(w), _j(b))
    return [np.asarray(t) for t in (y, dx, dw, db)]


def _close(got, want, err=""):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               err_msg=err)


@pytest.mark.parametrize("gather", [True, False])
def test_column_parallel_linear(mp_job, gather):
    a, _, res = mp_job
    name = "col_gather" if gather else "col_local"
    y, dx, dw, db = _linear_ref(a["x"], a["w"], a["b"], a["gy"])
    for r in range(2):
        c = slice(3 * r, 3 * r + 3)
        _close(res[r][f"{name}/out"], y if gather else y[:, c], name)
        _close(res[r][f"{name}/dx"], dx, name)
        _close(res[r][f"{name}/dw"], dw[:, c], name)
        _close(res[r][f"{name}/db"], db[c], name)


@pytest.mark.parametrize("parallel_input", [False, True])
def test_row_parallel_linear(mp_job, parallel_input):
    a, _, res = mp_job
    name = "row_parallel" if parallel_input else "row_split"
    y, dx, dw, db = _linear_ref(a["x6"], a["w_row"], a["b8"], a["gy8"])
    for r in range(2):
        c = slice(3 * r, 3 * r + 3)
        _close(res[r][f"{name}/out"], y, name)
        _close(res[r][f"{name}/dx"], dx[:, c] if parallel_input else dx)
        _close(res[r][f"{name}/dw"], dw[c], name)
        _close(res[r][f"{name}/db"], db, name)


def test_vocab_parallel_embedding(mp_job):
    a, _, res = mp_job
    jmesh.reset_mesh()
    jmesh.init_mesh(devices=jax.devices()[:1])
    emb = jnn.Embedding(16, 4)
    emb.weight.set_value(a["emb"])
    want = emb(paddle.to_tensor(a["ids"])).numpy()
    dw = np.zeros_like(a["emb"])
    np.add.at(dw, a["ids"].reshape(-1), a["gy_emb"].reshape(-1, 4))
    for r in range(2):
        _close(res[r]["emb/out"], want)
        _close(res[r]["emb/dw"], dw[8 * r:8 * r + 8])


def test_parallel_cross_entropy_with_ignore_index(mp_job):
    a, _, res = mp_job
    import paddle_tpu.nn.functional as JF

    lg = paddle.to_tensor(a["logits"])
    lg.stop_gradient = False
    want = JF.cross_entropy(lg, paddle.to_tensor(a["labels"]),
                            reduction="none", ignore_index=-100)
    want.sum().backward()
    wl, wg = want.numpy().reshape(-1), lg.grad.numpy()
    assert wl[2] == 0.0
    for r in range(2):
        _close(res[r]["ce/loss"].reshape(-1), wl)
        _close(res[r]["ce/dlogits"], wg[:, 8 * r:8 * r + 8])


def test_mp_pairing_does_not_scale_gradients(mp_job):
    """copy_to_mp on the column input and allreduce_mp on the row output:
    the input gradient and both weight gradients equal the serial MLP's,
    not mp times them."""
    a, _, res = mp_job

    def f(x, w1, w2):
        h = jax.nn.gelu(x @ w1 + a["b1"], approximate=False) @ w2 + a["b2"]
        return jnp.sum(h * a["gy_mlp"]), h

    (_, h), g = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        _j(a["x"]), _j(a["w1"]), _j(a["w2"]))
    dx, dw1, dw2 = [np.asarray(t) for t in g]
    for r in range(2):
        _close(res[r]["mlp/out"], np.asarray(h))
        _close(res[r]["mlp/dx"], dx)
        _close(res[r]["mlp/dw1"], dw1[:, 8 * r:8 * r + 8])
        _close(res[r]["mlp/dw2"], dw2[8 * r:8 * r + 8])


def test_flat_gpt_per_head_qkv_shard(mp_job):
    """The flat GPT at mp 2: each rank's qkv shard holds its heads from
    each of q, k and v ([3, nh/mp, hd]); the whole logits and the loss
    equal the reference's serial model on the same weights."""
    _, (w, ids), res = mp_job
    jmesh.reset_mesh()
    jmesh.init_mesh(devices=jax.devices()[:1])
    jm = JaxGPT(JaxCfg(**worker.CFG))
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in w.items()})
    from paddle_tpu.text.models import GPTPretrainingCriterion as JCrit

    with jax.default_matmul_precision("highest"):
        t = paddle.to_tensor(ids)
        logits = jm(t)
        loss = float(JCrit()(logits, t).numpy())
    for r in range(2):
        np.testing.assert_allclose(res[r]["gpt/logits"], logits.numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(res[r]["gpt/loss"]), loss,
                                   rtol=1e-5)
        np.testing.assert_allclose(float(res[r]["gpt/fused_loss"]), loss,
                                   rtol=1e-5)
    # each rank's qkv gradient is its columns of the whole [3, nh, hd]
    assert res[0]["gpt/dqkv"].shape == (64, 96)


def test_qkv_layouts_pinned():
    """The flat GPT's [3, nh, hd] qkv: a rank's columns are three strided
    runs (its heads of q, of k, of v); the pipelined GPT's head-major
    [nh, 3, hd]: one contiguous run, its heads' q, k and v."""
    from paddle_tpu_torch.convert import cut_pipelined_state
    from paddle_tpu_torch.text.models.gpt import GPTConfig

    cols = tmpu.qkv_shard_columns(8, 4, 2, 1)
    assert cols.tolist() == [4, 5, 6, 7, 12, 13, 14, 15, 20, 21, 22, 23]
    # a contiguous shard of the flat layout would cut across q and k
    assert tmpu.qkv_shard_columns(8, 4, 2, 0).tolist() != list(range(12))
    with pytest.raises(ValueError, match="num_heads"):
        tmpu.qkv_shard_columns(8, 3, 2, 0)
    cfg = GPTConfig(vocab_size=16, hidden_size=8, num_layers=2,
                    num_heads=4, max_seq_len=4)
    whole = np.arange(2 * 8 * 24, dtype=np.float32).reshape(2, 8, 24)
    cut = cut_pipelined_state({"stk_qkv_w": whole}, cfg, 1, 2, 0, 1)
    np.testing.assert_array_equal(cut["stk_qkv_w"].numpy(),
                                  whole[:, :, 12:24])


def test_split_matches_the_reference_cases(mp_job):
    """split's linear (axis 1 and 0) and embedding shapes as the
    reference's test_distributed_api_extra; their values equal the whole
    layers' that `split` builds at world 1 from the same seed."""
    a, _, res = mp_job
    tmesh.reset_mesh()
    trng.seed(5)
    x = torch.from_numpy(a["x"])
    col = tdist.split(x, (8, 6), operation="linear", axis=1)
    row = tdist.split(x, (8, 6), operation="linear", axis=0)
    emb = tdist.split(torch.from_numpy(a["ids"][:2, :2]), (16, 4),
                      operation="embedding")
    assert tuple(col.shape) == (4, 6) and tuple(row.shape) == (4, 6)
    assert tuple(emb.shape) == (2, 2, 4)
    with pytest.raises(ValueError):
        tdist.split(x, (8, 6), operation="conv")
    for r in range(2):
        _close(res[r]["split/col"], col.detach().numpy())
        _close(res[r]["split/row"], row.detach().numpy())
        _close(res[r]["split/emb"], emb.detach().numpy())
        assert int(res[r]["split/conv_raises"]) == 1


def _jax_quantized(layers, x):
    from paddle_tpu.quantization.runtime import quantize_model_int8

    jmesh.reset_mesh()
    jmesh.init_mesh(mp=2, devices=jax.devices()[:2])
    try:
        m = jnn.Sequential(*layers)
        rep = quantize_model_int8(m)
        return rep, m(paddle.to_tensor(x)).numpy(), m
    finally:
        jmesh.reset_mesh()


def _jlin(w, b):
    lin = jnn.Linear(w.shape[0], w.shape[1])
    lin.weight.set_value(w)
    lin.bias.set_value(b)
    return lin


def test_int8_tp_placements_and_outputs(mp_job):
    """quantize_model_int8(tp_shard=True) at mp 2: the whole Linears take
    the reference's placements (column where out divides, else row), and
    the outputs equal the reference's quantized model's; the parallel
    layers' shards keep theirs, the row shard's codes being the rows of
    the whole weight's codes."""
    from paddle_tpu.quantization import quantize_weight_int8

    a, _, res = mp_job
    rep, want, jm = _jax_quantized(
        [_jlin(a["q_w1"], a["q_b1"]), jnn.ReLU(),
         _jlin(a["q_w2"], a["q_b2"])], a["q_x"])
    rep_row, want_row, _ = _jax_quantized([_jlin(a["q_w3"], a["q_b3"])],
                                          a["q_x32"])
    assert rep["tp_placements"] == {"0": "column", "2": "column"}
    assert rep_row["tp_placements"] == {"0": "row"}
    codes2 = quantize_weight_int8(a["q_w2"], axis=1)[0]
    for r in range(2):
        assert json.loads(str(res[r]["int8/placements"])) == \
            rep["tp_placements"]
        np.testing.assert_allclose(res[r]["int8/out"], want, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(
            res[r]["int8/w_step0"],
            np.asarray(jm[0].w_step.numpy())[:, 16 * r:16 * r + 16],
            rtol=1e-6)
        assert str(res[r]["int8/row_placement"]) == "row"
        np.testing.assert_allclose(res[r]["int8/row_out"], want_row,
                                   rtol=2e-2, atol=2e-2)
        assert json.loads(str(res[r]["int8/par_placements"])) == {
            "0": "column", "2": "row"}
        np.testing.assert_array_equal(res[r]["int8/par_row_codes"],
                                      codes2[16 * r:16 * r + 16])
        np.testing.assert_allclose(res[r]["int8/par_out"], want, rtol=2e-2,
                                   atol=2e-2)


def test_tensor_parallel_broadcasts_replicated_parameters(mp_job):
    """fleet.TensorParallel returns the layers after the replicated
    parameters take the mp group's first rank's values; each rank's mp
    shard stays its own."""
    _, _, res = mp_job
    for r in range(2):
        np.testing.assert_array_equal(res[r]["tp/replicated"],
                                      np.full((3, 3), 1.0, np.float32))
        np.testing.assert_array_equal(res[r]["tp/shard"],
                                      np.full((3, 2), 10.0 + r, np.float32))


def test_world_one_layers_are_their_plain_counterparts():
    """At mp 1 each layer holds the whole weight and is the plain layer;
    the mp ops are the identity."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import mp_ops

    tmesh.reset_mesh()
    col = tmpu.ColumnParallelLinear(4, 6, device="cpu")
    row = tmpu.RowParallelLinear(6, 4, device="cpu")
    emb = tmpu.VocabParallelEmbedding(10, 4, device="cpu")
    assert tuple(col.weight.shape) == (4, 6)
    assert tuple(row.weight.shape) == (6, 4)
    assert tuple(emb.weight.shape) == (10, 4)
    x = torch.randn(2, 4)
    for op in (mp_ops.copy_to_mp, mp_ops.allreduce_mp, mp_ops.gather_mp,
               mp_ops.split_mp):
        assert op(x) is x
    assert tmpu.shard_activation(x, "dp", None) is x
    p = tmpu.mark_sharding(torch.nn.Parameter(torch.zeros(2)), "mp")
    assert tuple(p._pspec) == ("mp",)
