"""The pipelined GPT at world 1 (paddle_tpu_torch/text/models/
gpt_pipeline.py, the degenerate pipeline path, convert.py's layouts)
against the JAX package's.

The reference's `PipelinedGPTForCausalLM` state dict loads into the
port's, whole, at world 1 (bench_gpt1p3b_pp's one-card mesh); three
TrainStep steps under each remat policy and each schedule track the
reference's trajectory, the no-grad loss equals the training one, and
`forward` gives the reference's logits. `convert` carries the weights
to the flat GPTForCausalLM and back (head-major qkv against
[3, nh, hd]); a rank's slices of a pp × mp mesh, interleaved stacks
included, gather back to the whole. The MoE model (moe_experts > 0) at
world 1 tracks the reference's trajectory and aux (tests/test_torch_moe
holds its routing, gradients and meshes). An sp > 1 mesh at pp 1 and
indivisible meshes raise the reference's messages
(tests/test_torch_sequence_parallel holds the sp meshes).

Tolerances: losses 1e-5 relative (f32 on CPU, the two frameworks'
summation orders; the reference's matmuls at "highest" precision);
logits 1e-5; the layout round trips are exact.
"""
import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.text.models.gpt import GPTConfig as JaxCfg
from paddle_tpu.text.models.gpt_pipeline import (
    PipelinedGPTForCausalLM as JaxPipe)
from paddle_tpu_torch import convert
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.jit import HybridTrainStep, TrainStep
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.text.models.gpt_pipeline import (
    PipelinedGPTForCausalLM)

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


CFG = dict(vocab_size=256, hidden_size=64, num_layers=4, num_heads=4,
           max_seq_len=32)
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _reset():
    tmesh.reset_mesh()
    yield
    tmesh.reset_mesh()
    jmesh.reset_mesh()


def _ids(seed=0):
    return np.random.default_rng(seed).integers(0, 256, (8, 32))


def _reference(ids, steps=3, **kw):
    """(weights, losses, logits of ids[:2]) of the reference at world 1."""
    jmesh.reset_mesh()
    jmesh.init_mesh(devices=jax.devices()[:1])
    with jax.default_matmul_precision("highest"):
        paddle.seed(0)
        m = JaxPipe(JaxCfg(**CFG), n_micro=4, **kw)
        w = {k: np.array(v.numpy()) for k, v in m.state_dict().items()}
        logits = m(paddle.to_tensor(ids[:2])).numpy()
        with paddle.no_grad():
            eval_loss = float(m.loss(paddle.to_tensor(ids)).numpy())
        opt = paddle.optimizer.AdamW(1e-3, parameters=m.parameters())
        step = paddle.jit.TrainStep(m, lambda mm, i: mm.loss(i), opt)
        t = paddle.to_tensor(ids)
        losses = [float(step(t).numpy()) for _ in range(steps)]
    jmesh.reset_mesh()
    return w, losses, logits, eval_loss


def _port(w, **kw):
    m = PipelinedGPTForCausalLM(GPTConfig(**CFG), n_micro=4, device="cpu",
                                **kw)
    return m.load_logical(w)


@pytest.fixture(scope="module")
def ref():
    return _reference(_ids())


def test_reference_state_dict_loads_whole(ref):
    w = ref[0]
    m = _port(w)
    sd = convert.export_state_dict(m)
    assert list(sd) == list(w)
    for k in w:
        np.testing.assert_array_equal(sd[k], w[k])


@pytest.mark.parametrize("remat,schedule", [
    ("stage", "1f1b"), ("layer", "1f1b"), (False, "1f1b"),
    ("stage", "gpipe")])
def test_world_one_trajectory_matches_reference(ref, remat, schedule):
    """The degenerate mesh (bench_gpt1p3b_pp on one card): straight-line,
    micro-batched, each remat policy honoured; the reference trains its
    default (remat="stage") and its own tests hold every policy to it."""
    w, losses = ref[0], ref[1]
    m = _port(w, remat=remat, schedule=schedule)
    step = TrainStep(m, lambda mm, i: mm.loss(i),
                     AdamW(1e-3, parameters=m.parameters()))
    got = [float(step(torch.as_tensor(_ids()))) for _ in range(3)]
    np.testing.assert_allclose(got, losses, rtol=RTOL)


def test_hybrid_train_step_at_world_one_equals_train_step(ref):
    w = ref[0]
    ids = torch.as_tensor(_ids())
    runs = []
    for cls in (TrainStep, HybridTrainStep):
        m = _port(w)
        step = cls(m, lambda mm, i: mm.loss(i),
                   AdamW(1e-3, parameters=m.parameters()))
        runs.append([float(step(ids)) for _ in range(3)])
    assert runs[0] == runs[1]


def test_forward_and_no_grad_loss(ref):
    w, losses, logits, eval_loss = ref
    m = _port(w)
    np.testing.assert_allclose(m(torch.as_tensor(_ids()[:2])).numpy(),
                               logits, rtol=RTOL, atol=1e-5)
    with torch.no_grad():
        got = float(m.loss(torch.as_tensor(_ids())))
    np.testing.assert_allclose(got, eval_loss, rtol=RTOL)
    np.testing.assert_allclose(got, losses[0], rtol=RTOL)


def test_flat_gpt_from_pipelined_weights(ref):
    """pipelined_to_gpt_state: the flat GPT on the same weights gives the
    same logits up to the two models' GELU (the pipelined GPT's is jax's
    default tanh form, the flat one's the exact erf), and the round trip
    back is exact."""
    w = ref[0]
    flat = convert.pipelined_to_gpt_state(w, GPTConfig(**CFG))
    g = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    convert.load_jax_state_dict(g, flat)
    m = _port(w)
    ids = torch.as_tensor(_ids()[:2])
    with torch.no_grad():
        np.testing.assert_allclose(g(ids).numpy(), m(ids).numpy(),
                                   rtol=0, atol=2e-3)
    back = convert.gpt_to_pipelined_state(flat, GPTConfig(**CFG))
    for k in w:
        np.testing.assert_array_equal(np.asarray(back[k]), w[k])


@pytest.mark.parametrize("pp,mp,V", [(2, 2, 1), (2, 1, 2), (4, 2, 1),
                                     (2, 2, 2)])
def test_cut_and_gather_round_trip(ref, pp, mp, V):
    """Every rank's slice by its (stage, mp rank), gathered back: the
    whole arrays. A stage's stack rows are its chunks' layers (round
    robin at V > 1); wte's rows by mp on the first and last stage."""
    w = {k: v for k, v in ref[0].items() if k != "aux_loss"}
    cfg = GPTConfig(**CFG)
    shards = {(s, r): convert.cut_pipelined_state(w, cfg, pp, mp, s, r, V)
              for s in range(pp) for r in range(mp)}
    back = convert.gather_pipelined_state(shards, cfg, pp, mp, V)
    for k in w:
        np.testing.assert_array_equal(back[k], w[k], err_msg=k)
    assert convert.stage_layers(4, 2, 1, 2) == [1, 3]
    s0 = shards[(0, 0)]
    assert "wpe" in s0 and "lnf_w" not in s0
    assert ("wte" in shards[(pp - 1, 0)]) and "lnf_w" in shards[(pp - 1, 0)]
    assert s0["stk_qkv_w"].shape == (4 // pp, 64, 192 // mp)
    assert s0["stk_proj_w"].shape == (4 // pp, 64 // mp, 64)


def test_moe_world_one_trajectory_matches_reference():
    """moe_experts=4 (top-1, the default capacity, which drops tokens
    here): the model holds the MoE leaves in place of the dense FFN, and
    three TrainStep steps track the reference's losses and aux."""
    ids = _ids(3)
    jmesh.reset_mesh()
    jmesh.init_mesh(devices=jax.devices()[:1])
    with jax.default_matmul_precision("highest"):
        paddle.seed(0)
        jm = JaxPipe(JaxCfg(**CFG), n_micro=4, moe_experts=4)
        w = {k: np.array(v.numpy()) for k, v in jm.state_dict().items()}
        step = paddle.jit.TrainStep(jm, lambda mm, i: mm.loss(i),
                                    paddle.optimizer.AdamW(
                                        1e-3, parameters=jm.parameters()))
        t = paddle.to_tensor(ids)
        want = []
        for _ in range(3):
            want.append((float(step(t).numpy()),
                         float(jm.aux_loss.numpy())))
    jmesh.reset_mesh()
    m = _port(w, moe_experts=4)
    assert m.stk_moe_w1.shape == (4, 4, 64, 256)
    assert not hasattr(m, "stk_fc1_w")
    step = TrainStep(m, lambda mm, i: mm.loss(i),
                     AdamW(1e-3, parameters=m.parameters()))
    got = []
    for _ in range(3):
        got.append((float(step(torch.as_tensor(ids))), float(m.aux_loss)))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_what_keeps_raising_and_validation():
    cfg = GPTConfig(**CFG)
    tmesh.init_mesh(sp=2, world_size=2)
    m = PipelinedGPTForCausalLM(cfg, device="cpu")
    # the reference's: sequence parallelism needs pp > 1
    with pytest.raises(ValueError, match="needs pp > 1"):
        m.loss(torch.zeros((8, 16), dtype=torch.long))
    tmesh.reset_mesh()
    for kw in (dict(schedule="pipedream"),
               dict(schedule="gpipe", n_virtual=2), dict(n_virtual=0),
               dict(remat="everything")):
        with pytest.raises(ValueError):
            PipelinedGPTForCausalLM(cfg, device="cpu", **kw)
    # the reference's messages for an indivisible mesh
    tmesh.init_mesh(pp=2, mp=4, world_size=8)
    bad = GPTConfig(vocab_size=256, hidden_size=30, num_layers=4,
                    num_heads=6, max_seq_len=32)
    with pytest.raises(ValueError, match="num_heads=6 not divisible"):
        PipelinedGPTForCausalLM(bad, device="cpu")
    tmesh.reset_mesh()
    tmesh.init_mesh(pp=2, dp=4, world_size=8)
    with pytest.raises(ValueError, match="num_layers=4 not divisible by "
                       r"pp\*n_virtual=2\*3"):
        PipelinedGPTForCausalLM(cfg, n_virtual=3, device="cpu")


def test_distributed_model_wraps_at_pp2(monkeypatch):
    """fleet.distributed_model at pp_degree > 1: the PipelineParallel
    wrapper (the world named by the env contract; no process group)."""
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    st = tfleet.DistributedStrategy()
    st.hybrid_configs["pp_degree"] = 2
    st.pipeline_configs["accumulate_steps"] = 4
    tfleet.init(is_collective=True, strategy=st)
    lin = torch.nn.Linear(2, 2)
    wrapped = tfleet.distributed_model(lin)
    assert wrapped._layers is lin and wrapped.accumulate_steps == 4
    x = torch.randn(3, 2)
    assert torch.equal(wrapped(x), lin(x))


def test_pipeline_parallel_one_stage_is_gradient_accumulation():
    """PipelineParallel.train_batch on one stage: the micro-batches'
    gradients accumulated, one step — the same update as the whole
    batch's mean loss."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, PipelineLayer)
    from paddle_tpu_torch.optimizer import SGD

    def build():
        torch.manual_seed(0)
        return PipelineLayer([LayerDesc(torch.nn.Linear, 4, 3)],
                             num_stages=1,
                             loss_fn=lambda o, y: ((o - y) ** 2).mean())

    x, y = torch.randn(8, 4), torch.randn(8, 3)
    a = build()
    st = tfleet.DistributedStrategy()
    st.pipeline_configs["accumulate_steps"] = 4
    pp = tfleet.PipelineParallel(a, None, st)
    loss = pp.train_batch((x, y), SGD(0.1, parameters=a.parameters()))
    b = build()
    opt = SGD(0.1, parameters=b.parameters())
    whole = b.loss_fn(b(x), y)
    whole.backward()
    opt.step()
    np.testing.assert_allclose(float(loss), float(whole.detach()),
                               rtol=1e-6)
    for p, q in zip(a.parameters(), b.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   rtol=1e-6, atol=1e-7)
    assert float(pp.eval_batch((x, y))) == pytest.approx(
        float(a.loss_fn(a(x), y)))


def test_profile_dist_mesh_mode_at_world_one(tmp_path, monkeypatch):
    """profile_dist --mesh on one process (the CPU plain versions): it
    trains the pipelined GPT through HybridTrainStep and writes the
    record the launched mode writes — losses, the schedule its stage ran,
    the comm counters, launches — and its parameter shards beside a
    checkpoint that a world-1 Checkpointer reads back."""
    import json

    from paddle_tpu_torch import profile_dist
    from paddle_tpu_torch.distributed.checkpoint import Checkpointer

    monkeypatch.setitem(profile_dist.MODELS, "tiny_pipe",
                        (lambda: GPTConfig(**CFG), False))
    profile_dist.main(["--model", "tiny_pipe", "--mesh", "pp=1,mp=1",
                       "--device", "cpu", "--batch", "8", "--seq", "32",
                       "--steps", "2",
                       "--ckpt", str(tmp_path / "ck"),
                       "--out", str(tmp_path)])
    out = json.load(open(tmp_path / "dist_out_0.json"))
    assert len(out["losses"]) == 2 and out["losses"][1] < out["losses"][0]
    assert out["coord"]["pp"] == 0 and out["mesh"]["mp"] == 1
    assert out["launches"] == {"flash_forward": 0, "flash_bwd_dq": 0,
                               "flash_bwd_dkv": 0}
    assert set(out["comm"][0]) == {"dp", "p2p", "mp", "tied_wte", "ring"}
    saved = dict(np.load(tmp_path / "params_0.npz"))
    m = PipelinedGPTForCausalLM(GPTConfig(**CFG), device="cpu")
    step = HybridTrainStep(m, lambda mm, i: mm.loss(i),
                           AdamW(1e-4, parameters=m.parameters()))
    assert Checkpointer(str(tmp_path / "ck"), model=m,
                        train_step=step).load_latest() == 2
    for n, p in m.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), saved[n])
    assert profile_dist.parse_mesh("pp=2,sp=2") == {"pp": 2, "sp": 2}
    with pytest.raises(ValueError, match="--mesh axis"):
        profile_dist.parse_mesh("pp=2,tp=2")
