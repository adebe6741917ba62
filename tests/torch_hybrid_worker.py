"""Worker of the port's tensor- and pipeline-parallel tests
(tests/test_torch_mp_layers.py, test_torch_pipeline.py,
test_torch_hybrid3d.py, test_torch_gpt_pipeline.py), run under
`python -m paddle_tpu_torch.distributed.launch`:

    torch_hybrid_worker.py mp OUT      # 2 ranks, mesh mp 2
    torch_hybrid_worker.py hybrid OUT  # 4 ranks: pp 2 x mp 2, dp 2 x pp 2
    torch_hybrid_worker.py 3d OUT      # 8 ranks: dp 2 x tp 2 x pp 2
    torch_hybrid_worker.py moe OUT     # 4 ranks: pp 2 x ep 2, ep 2 x dp 2
    torch_hybrid_worker.py quant OUT   # 2 or 4 ranks: quantized_pmean
    torch_hybrid_worker.py hybrid_quant OUT  # 4 ranks: dp 2 x pp 2, int8
    torch_hybrid_worker.py ring OUT    # 4 ranks: sp 4, then dp 2 x sp 2
    torch_hybrid_worker.py seq_step OUT  # 2 ranks sp 2, or 4: dp 2 x sp 2
    torch_hybrid_worker.py sp_pipe OUT # 4 ranks: pp 2 x sp 2
    torch_hybrid_worker.py sp_3d OUT   # 8 ranks: pp 2 x mp 2 x sp 2
    torch_hybrid_worker.py auto OUT    # 2 ranks: the auto-parallel Engine
    torch_hybrid_worker.py bn OUT      # 2 ranks dp 2, or 4: dp 2 x sharding 2
    torch_hybrid_worker.py bert_mp OUT # 2 ranks: BERT at mp 2

Inputs and whole weights come from OUT (written by the test from a seed
with numpy and from the reference's models); each rank writes its
results to OUT as npz / JSON.
"""
import json
import os
import sys

import numpy as np

# the small GPT of the hybrid tests (bench_train_3d's geometry)
CFG = dict(vocab_size=256, hidden_size=64, num_layers=4, num_heads=4,
           max_seq_len=32)
N_MICRO, STEPS, LR = 4, 3, 1e-3


def _root():
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg():
    from paddle_tpu_torch.text.models.gpt import GPTConfig

    return GPTConfig(**CFG)


def _np(t):
    t = t.detach()
    if t.dtype.is_floating_point:
        t = t.float()
    return t.cpu().numpy()


# ---- mp 2: the Megatron layers ---------------------------------------

def mp(out):
    import torch

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        mp_layers as mpu)
    from paddle_tpu_torch.distributed.hybrid3d import int8_tp_placement
    from paddle_tpu_torch.quantization.runtime import quantize_model_int8

    D.init_parallel_env(mp=2, device="cpu")
    torch.set_num_threads(1)
    rank = D.get_rank()
    a = {k: torch.from_numpy(v) for k, v in
         np.load(os.path.join(out, "mp_inputs.npz")).items()}
    res = {}

    def run(name, layer, x, gy, w, b=None):
        mpu.load_full(layer, w, b)
        x = x.clone().requires_grad_()
        y = layer(x)
        (y * gy).sum().backward()
        res[f"{name}/out"] = _np(y)
        res[f"{name}/dx"] = _np(x.grad)
        res[f"{name}/dw"] = _np(layer.weight.grad)
        if layer.bias is not None:
            res[f"{name}/db"] = _np(layer.bias.grad)

    c = slice(rank * 3, rank * 3 + 3)
    run("col_gather", mpu.ColumnParallelLinear(8, 6, device="cpu"),
        a["x"], a["gy"], a["w"], a["b"])
    run("col_local", mpu.ColumnParallelLinear(8, 6, gather_output=False,
                                              device="cpu"),
        a["x"], a["gy"][:, c], a["w"], a["b"])
    run("row_split", mpu.RowParallelLinear(6, 8, device="cpu"),
        a["x6"], a["gy8"], a["w_row"], a["b8"])
    run("row_parallel", mpu.RowParallelLinear(6, 8, input_is_parallel=True,
                                              device="cpu"),
        a["x6"][:, c], a["gy8"], a["w_row"], a["b8"])
    emb = mpu.load_full(mpu.VocabParallelEmbedding(16, 4, device="cpu"),
                        a["emb"])
    e = emb(a["ids"])
    (e * a["gy_emb"]).sum().backward()
    res["emb/out"], res["emb/dw"] = _np(e), _np(emb.weight.grad)
    # vocab-parallel CE on this rank's 8 of the 16 vocab columns
    lg = a["logits"][:, rank * 8:rank * 8 + 8].clone().requires_grad_()
    loss = mpu.ParallelCrossEntropy(ignore_index=-100)(lg, a["labels"])
    loss.sum().backward()
    res["ce/loss"], res["ce/dlogits"] = _np(loss), _np(lg.grad)
    # a Megatron MLP: column (no gather) -> gelu -> row (parallel input);
    # copy_to_mp / allreduce_mp must give the serial input gradient
    col = mpu.load_full(mpu.ColumnParallelLinear(
        8, 16, gather_output=False, device="cpu"), a["w1"], a["b1"])
    row = mpu.load_full(mpu.RowParallelLinear(
        16, 8, input_is_parallel=True, device="cpu"), a["w2"], a["b2"])
    x = a["x"].clone().requires_grad_()
    h = row(torch.nn.functional.gelu(col(x)))
    (h * a["gy_mlp"]).sum().backward()
    res["mlp/out"], res["mlp/dx"] = _np(h), _np(x.grad)
    res["mlp/dw1"], res["mlp/dw2"] = _np(col.weight.grad), _np(
        row.weight.grad)
    # the flat GPT at mp 2 (per-head qkv shard) from the reference's
    # weights: the loss and the whole logits
    from paddle_tpu_torch.convert import cut_gpt_state, load_jax_state_dict
    from paddle_tpu_torch.text.models.gpt import (GPTForCausalLM,
                                                  GPTPretrainingCriterion)

    gw = dict(np.load(os.path.join(out, "gpt_weights.npz")))
    ids = torch.from_numpy(np.load(os.path.join(out, "gpt_ids.npy")))
    m = GPTForCausalLM(_cfg(), device="cpu")
    load_jax_state_dict(m, cut_gpt_state(gw, _cfg(), 2, rank))
    logits = m(ids)
    gl = GPTPretrainingCriterion()(logits, ids)
    gl.backward()
    res["gpt/loss"] = _np(gl)
    res["gpt/logits"] = _np(_gather_last(logits))
    res["gpt/dqkv"] = _np(m.gpt.layers[0].qkv.weight.grad)
    res["gpt/fused_loss"] = _np(m.fused_head_loss(ids))
    # split: the op-level layers from core.rng's stream
    rng.seed(5)
    xs = a["x"]
    res["split/col"] = _np(D.split(xs, (8, 6), operation="linear", axis=1))
    res["split/row"] = _np(D.split(xs, (8, 6), operation="linear", axis=0))
    res["split/emb"] = _np(D.split(a["ids"][:2, :2], (16, 4),
                                   operation="embedding"))
    try:
        D.split(xs, (8, 6), operation="conv")
    except ValueError:
        res["split/conv_raises"] = np.array(1)
    # int8 TP: whole Linears cut by quantize_model_int8(tp_shard=True);
    # the parallel layers' own shards quantized in place
    seq = torch.nn.Sequential(
        _linear(a["q_w1"], a["q_b1"]), torch.nn.ReLU(),
        _linear(a["q_w2"], a["q_b2"]))
    rep = quantize_model_int8(seq)
    res["int8/placements"] = np.array(json.dumps(rep["tp_placements"]))
    res["int8/out"] = _np(seq(a["q_x"]))
    res["int8/w_step0"] = _np(seq[0].w_step)
    lin = torch.nn.Sequential(_linear(a["q_w3"], a["q_b3"]))
    quantize_model_int8(lin)
    res["int8/row_out"] = _np(lin(a["q_x32"]))
    res["int8/row_placement"] = np.array(int8_tp_placement(lin[0]))
    par = torch.nn.Sequential(
        mpu.load_full(mpu.ColumnParallelLinear(16, 32, gather_output=False,
                                               device="cpu"),
                      a["q_w1"], a["q_b1"]),
        torch.nn.ReLU(),
        mpu.load_full(mpu.RowParallelLinear(32, 8, input_is_parallel=True,
                                            device="cpu"),
                      a["q_w2"], a["q_b2"]))
    rep = quantize_model_int8(par)
    res["int8/par_placements"] = np.array(json.dumps(rep["tp_placements"]))
    res["int8/par_out"] = _np(par(a["q_x"]))
    res["int8/par_row_codes"] = _np(par[2].weight_q)
    # TensorParallel: replicated parameters from the mp group's first
    # rank, the shards untouched
    tp = torch.nn.Sequential(
        torch.nn.Linear(3, 3),
        mpu.ColumnParallelLinear(3, 4, gather_output=False, device="cpu"))
    with torch.no_grad():
        tp[0].weight.fill_(float(rank + 1))
        tp[1].weight.fill_(float(rank + 10))
    assert fleet.TensorParallel(tp) is tp
    res["tp/replicated"] = _np(tp[0].weight)
    res["tp/shard"] = _np(tp[1].weight)
    np.savez(os.path.join(out, f"mp_r{rank}.npz"), **res)


def _linear(w, b):
    import torch

    from paddle_tpu_torch.nn.layer.common import Linear

    lin = Linear(w.shape[0], w.shape[1], device="cpu")
    with torch.no_grad():
        lin.weight.copy_(w)
        lin.bias.copy_(b)
    return lin


def _gather_last(t):
    from paddle_tpu_torch.distributed.fleet.meta_parallel.mp_ops import (
        gather_mp)

    return gather_mp(t.detach())


# ---- pp 2 x mp 2 and dp 2 x pp 2: the pipelined GPT -------------------

HYBRID_RUNS = [
    # (name, mesh, model kwargs, step config kwargs)
    ("pp2mp2", dict(pp=2, mp=2), {}, {}),
    ("gpipe", dict(pp=2, mp=2), dict(schedule="gpipe"), {}),
    ("v2", dict(pp=2, mp=2), dict(n_virtual=2), {}),
    ("layer", dict(pp=2, mp=2), dict(remat="layer"), {}),
    ("dp2pp2_zero_os", dict(dp=2, pp=2), {}, dict(zero="os")),
    # shard_storage: parameter blocks over 'sharding' (ZeRO p_g_os)
    ("pp2_storage", dict(pp=2, sharding=2), {}, {}),
]


def _model(w, **kw):
    from paddle_tpu_torch.text.models.gpt_pipeline import (
        PipelinedGPTForCausalLM)

    m = PipelinedGPTForCausalLM(_cfg(), n_micro=N_MICRO, device="cpu",
                                **kw)
    return m.load_logical(w)


def _local_state(m):
    return {n: _np(p) for n, p in m.named_parameters()}


def hybrid(out):
    import torch

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.distributed.checkpoint import Checkpointer
    from paddle_tpu_torch.distributed.fleet.meta_parallel import mp_ops
    # the module (its package re-exports the function of the same name)
    p1 = sys.modules["paddle_tpu_torch.distributed.fleet.meta_parallel."
                     "pipeline_1f1b"]
    from paddle_tpu_torch.distributed.hybrid3d import (Hybrid3DConfig,
                                                       build_gpt3d)
    from paddle_tpu_torch.jit import HybridTrainStep
    from paddle_tpu_torch.optimizer import AdamW

    D.init_parallel_env(device="cpu")
    torch.set_num_threads(1)
    rank = D.get_rank()
    w = dict(np.load(os.path.join(out, "pipe_weights.npz")))
    ids = torch.from_numpy(np.load(os.path.join(out, "pipe_ids.npy")))
    res = {}
    for name, mesh, model_kw, step_kw in HYBRID_RUNS:
        mesh_mod.init_mesh(**mesh)
        coord = mesh_mod.coord()
        res[f"{name}/coord"] = [coord["dp"], coord["pp"], coord["mp"]]
        if name == "pp2mp2":
            # the gradients of one loss at the reference's weights
            m = _model(w, **model_kw)
            m.loss(ids).backward()
            np.savez(os.path.join(out, f"grads_r{rank}.npz"),
                     **{n: _np(p.grad) for n, p in m.named_parameters()})
            with torch.no_grad():
                res["eval/no_grad_loss"] = float(m.loss(ids))
            res["eval/grad_loss"] = float(m.loss(ids).detach())
            res["forward/logits_sum"] = float(m(ids[:2]).double().sum())
        cfg3d = Hybrid3DConfig(**{k: mesh.get(k, 1) for k in ("dp", "pp")},
                               tp=mesh.get("mp", 1), n_micro=N_MICRO,
                               **step_kw,
                               **({"schedule": model_kw["schedule"]}
                                  if "schedule" in model_kw else {}),
                               **({"n_virtual": model_kw["n_virtual"]}
                                  if "n_virtual" in model_kw else {}),
                               **({"remat": model_kw["remat"]}
                                  if "remat" in model_kw else {}))
        m = build_gpt3d(_cfg(), cfg3d, device="cpu").load_logical(w)
        if "sharding" in mesh:
            m.shard_storage()
        opt = AdamW(LR, parameters=m.parameters())
        step = HybridTrainStep(m, lambda mm, i: mm.loss(i), opt,
                               config=cfg3d)
        p1.stats.clear()
        mp_ops.reset_stats()
        res[f"{name}/losses"] = [float(step(ids)) for _ in range(STEPS)]
        res[f"{name}/schedule"] = [list(map(str, r))
                                   for r in p1.last_schedule]
        res[f"{name}/describe"] = step.describe()
        np.savez(os.path.join(out, f"{name}_params_r{rank}.npz"),
                 **_local_state(m))
        if name == "pp2mp2":
            res["pp2mp2/p2p"] = dict(p1.stats)
            res["pp2mp2/mp"] = dict(mp_ops.stats)
            res["pp2mp2/tied"] = dict(m.tied_stats)
            ck = Checkpointer(os.path.join(out, "ckpt"), model=m,
                              train_step=step)
            ck.save(STEPS)
        if name == "pp2_storage":
            res[f"{name}/block_shapes"] = {
                n: list(p.shape) for n, p in m.named_parameters()}
            full = step.full_parameters()
            np.savez(os.path.join(out, f"{name}_params_r{rank}.npz"),
                     **{n: _np(t) for n, t in full.items()})
        if name == "dp2pp2_zero_os":
            res[f"{name}/moment_shapes"] = sorted(
                {str(tuple(v.shape)) for st in opt._states.values()
                 for v in st.values() if v.dim()})
        mesh_mod.reset_mesh()
    res.update(_pipeline_layer(rank))
    with open(os.path.join(out, f"hybrid_r{rank}.json"), "w") as f:
        json.dump(res, f)


def pipeline_layer_descs():
    """A 4-entry stack: a tied embedding, two Linears, the tied head."""
    import torch

    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, SharedLayerDesc)

    def head(emb, x):
        return x @ emb.weight.t()

    return [SharedLayerDesc("emb", torch.nn.Embedding, None, "weight",
                            12, 6),
            LayerDesc(torch.nn.Linear, 6, 6),
            LayerDesc(torch.nn.Linear, 6, 6),
            SharedLayerDesc("emb", torch.nn.Embedding, head, "weight",
                            12, 6)]


def pipeline_layer_run(distributed_model=None):
    """Two train_batch steps of the PipelineLayer stack from seeded
    weights: (losses, {name: param})."""
    import torch

    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        PipelineLayer)
    from paddle_tpu_torch.optimizer import SGD

    torch.manual_seed(0)
    stack = PipelineLayer(
        pipeline_layer_descs(), num_stages=2,
        loss_fn=lambda out, y: torch.nn.functional.cross_entropy(
            out.reshape(-1, out.shape[-1]), y.reshape(-1)))
    # every stage starts from the same seeded logical weights
    gen = torch.Generator().manual_seed(1)
    full = {"0.weight": torch.randn(12, 6, generator=gen) * 0.3}
    for i in (1, 2):
        full[f"{i}.weight"] = torch.randn(6, 6, generator=gen) * 0.3
        full[f"{i}.bias"] = torch.zeros(6)
    with torch.no_grad():
        for n, p in stack.named_parameters():
            # the head's copy of the shared embedding is entry 3's
            p.copy_(full.get(n, full["0.weight"]))
    st = fleet.DistributedStrategy()
    st.pipeline_configs["accumulate_steps"] = 2
    model = fleet.PipelineParallel(stack, None, st)
    opt = SGD(0.1, parameters=stack.parameters())
    gen = torch.Generator().manual_seed(2)
    x = torch.randint(0, 12, (4, 5), generator=gen)
    y = torch.randint(0, 12, (4, 5), generator=gen)
    losses = [float(model.train_batch((x, y), opt)) for _ in range(2)]
    with torch.no_grad():
        ev = float(model.eval_batch((x, y)))
    return losses, ev, {n: _np(p) for n, p in stack.named_parameters()}


def _pipeline_layer(rank):
    from paddle_tpu_torch.distributed import mesh as mesh_mod

    mesh_mod.init_mesh(dp=2, pp=2)
    losses, ev, params = pipeline_layer_run()
    out = {"pplayer/losses": losses, "pplayer/eval": ev,
           "pplayer/params": {k: v.tolist() for k, v in params.items()}}
    out.update(_generic(rank))
    mesh_mod.reset_mesh()
    return out


def generic_inputs():
    """The functional pipeline cases' inputs: a 4-layer tanh stack, a
    head, 6 micro-batches of 2 rows (the reference's test_pipeline_1f1b
    shapes, cut to 4 layers)."""
    rng = np.random.default_rng(0)
    L, d, M, mb = 4, 8, 6, 2
    return dict(
        W=(rng.standard_normal((L, d, d)) * 0.3).astype(np.float32),
        Wh=(rng.standard_normal((d, 3)) * 0.3).astype(np.float32),
        xs=rng.standard_normal((M, mb, d)).astype(np.float32),
        ys=rng.integers(0, 3, (M, mb)).astype(np.int64),
        G=rng.standard_normal((M, mb, d)).astype(np.float32))


def _generic(rank):
    """pipeline_1f1b, pipeline_gpipe, interleaved_pipeline_loss,
    spmd_pipeline and HybridParallelInferenceHelper over plain tensors on
    a pp 2 stage pair: losses, outputs and each rank's gradients."""
    import torch

    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        interleaved_pipeline_loss, pipeline_1f1b, spmd_pipeline)
    from paddle_tpu_torch.distributed.fleet.utils import (
        HybridParallelInferenceHelper)
    from paddle_tpu_torch.distributed.hybrid3d import pipeline_gpipe

    a = {k: torch.from_numpy(v) for k, v in generic_inputs().items()}
    stage = mesh_mod.axis_index("pp")

    def block(w, x):
        for i in range(w.shape[0]):
            x = torch.tanh(x @ w[i])
        return x

    def head(y, labels, wh):
        lp = torch.log_softmax(y @ wh, -1)
        return -lp.gather(-1, labels[..., None]).mean()

    out = {}
    rows = {1: [2 * stage, 2 * stage + 1], 2: [stage, stage + 2]}
    for name, fn, V in (("1f1b", pipeline_1f1b, 1),
                        ("gpipe", pipeline_gpipe, 1),
                        ("interleaved", interleaved_pipeline_loss, 2)):
        w = a["W"][rows[V]]
        if V > 1:
            w = w.reshape(2, 1, 8, 8)   # [V, layers a chunk, d, d]
        w = w.clone().requires_grad_()
        wh = a["Wh"].clone().requires_grad_()
        xs = a["xs"].clone().requires_grad_()
        if V > 1:
            loss = fn(block, head, w, wh, (xs, a["ys"]), num_virtual=2,
                      remat=False)
        else:
            loss = fn(block, head, w, wh, (xs, a["ys"]))
        loss.backward()
        out[f"gen/{name}/loss"] = float(loss)
        out[f"gen/{name}/dw"] = w.grad.reshape(2, 8, 8).tolist()
        out[f"gen/{name}/dwh"] = None if wh.grad is None else \
            wh.grad.tolist()
        out[f"gen/{name}/dx"] = None if xs.grad is None else \
            xs.grad.tolist()
    # PipelineSpecs.dp_axis: each dp rank runs its row of every micro,
    # the loss and the gradients averaged over dp inside the pipeline
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        PipelineSpecs)

    r = mesh_mod.axis_index("dp")
    w = a["W"][rows[1]].clone().requires_grad_()
    wh = a["Wh"].clone().requires_grad_()
    xs = a["xs"][:, r:r + 1].clone().requires_grad_()
    loss = pipeline_1f1b(block, head, w, wh, (xs, a["ys"][:, r:r + 1]),
                         specs=PipelineSpecs(dp_axis="dp"))
    loss.backward()
    out["gen/dp/loss"] = float(loss)
    out["gen/dp/dw"] = w.grad.tolist()
    out["gen/dp/dwh"] = None if wh.grad is None else wh.grad.tolist()
    out["gen/dp/dx"] = None if xs.grad is None else xs.grad.tolist()
    # the aux channel: each layer adds mean(y²) to the aux (over dp its
    # all-reduce / 2, the global value), weighted 0.1; and the int8 dp
    # exchange of PipelineSpecs(quant_dp=True)
    from paddle_tpu_torch.distributed.fleet.meta_parallel.mp_ops import (
        allreduce_mp)

    def block_aux(w, x, dp):
        aux = 0.0
        for i in range(w.shape[0]):
            x = torch.tanh(x @ w[i])
            m = (x * x).mean()
            aux = aux + (allreduce_mp(m, "dp") / 2 if dp else m)
        return x, aux

    for name, specs in (("aux", None),
                        ("dp_aux", PipelineSpecs(dp_axis="dp")),
                        ("dp_quant", PipelineSpecs(dp_axis="dp",
                                                   quant_dp=True))):
        dp = specs is not None
        sl = slice(r, r + 1) if dp else slice(None)
        w = a["W"][rows[1]].clone().requires_grad_()
        wh = a["Wh"].clone().requires_grad_()
        xs = a["xs"][:, sl].clone().requires_grad_()
        batch = (xs, a["ys"][:, sl])
        aux = None
        if name == "dp_quant":
            loss = pipeline_1f1b(block, head, w, wh, batch, specs=specs)
        else:
            loss, aux = pipeline_1f1b(
                lambda w_, x_, _dp=dp: block_aux(w_, x_, _dp), head, w, wh,
                batch, specs=specs, aux_weight=0.1)
        loss.backward()
        out[f"gen/{name}/loss"] = float(loss)
        out[f"gen/{name}/aux"] = None if aux is None else float(aux)
        out[f"gen/{name}/dw"] = w.grad.tolist()
        out[f"gen/{name}/dwh"] = None if wh.grad is None else \
            wh.grad.tolist()
        out[f"gen/{name}/dx"] = None if xs.grad is None else \
            xs.grad.tolist()
    w = a["W"][rows[1]].clone().requires_grad_()
    xs = a["xs"].clone().requires_grad_()
    y = spmd_pipeline(block, w, xs)
    (y * a["G"]).sum().backward()
    out["gen/spmd/out"] = y.detach().tolist()
    out["gen/spmd/dw"] = w.grad.tolist()
    out["gen/spmd/dx"] = xs.grad.tolist()
    helper = HybridParallelInferenceHelper(
        block, a["W"][rows[1]], head_fn=lambda x, wh: x @ wh,
        post_params=a["Wh"], micro_batches=3)
    out["gen/infer"] = helper.forward(a["xs"].reshape(12, 8)[:11]).tolist()
    return out


# ---- dp 2 x tp 2 x pp 2 ------------------------------------------------

def three_d(out):
    import torch

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed.hybrid3d import (Hybrid3DConfig,
                                                       build_gpt3d,
                                                       init_hybrid_mesh)
    from paddle_tpu_torch.jit import HybridTrainStep
    from paddle_tpu_torch.optimizer import AdamW

    D.init_parallel_env(device="cpu")
    torch.set_num_threads(1)
    rank = D.get_rank()
    w = dict(np.load(os.path.join(out, "pipe_weights.npz")))
    ids = torch.from_numpy(np.load(os.path.join(out, "pipe_ids.npy")))
    cfg3d = Hybrid3DConfig(dp=2, tp=2, pp=2, n_micro=N_MICRO)
    init_hybrid_mesh(cfg3d)
    m = build_gpt3d(_cfg(), cfg3d, device="cpu").load_logical(w)
    step = HybridTrainStep(m, lambda mm, i: mm.loss(i),
                           AdamW(LR, parameters=m.parameters()),
                           config=cfg3d)
    res = {"losses": [float(step(ids)) for _ in range(STEPS)],
           "tag": cfg3d.tag(), "describe": step.describe(),
           "grad_bytes": step.comm_stats.get("bytes", 0)}
    with open(os.path.join(out, f"3d_r{rank}.json"), "w") as f:
        json.dump(res, f)



# ---- the MoE GPT: pp 2 x ep 2, ep 2 x dp 2 ----------------------------

MOE = dict(moe_experts=4, moe_hidden=64, moe_capacity_factor=4.0)
MOE_RUNS = [("pp2ep2", dict(pp=2, ep=2), dict(moe_topk=1)),
            ("ep2dp2", dict(dp=2, ep=2), dict(moe_topk=2))]


def moe(out):
    import torch

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.distributed.checkpoint import Checkpointer
    from paddle_tpu_torch.distributed.fleet.meta_parallel import mp_ops
    from paddle_tpu_torch.jit import HybridTrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models.gpt_pipeline import (
        PipelinedGPTForCausalLM)

    D.init_parallel_env(device="cpu")
    torch.set_num_threads(1)
    rank = D.get_rank()
    w = dict(np.load(os.path.join(out, "moe_weights.npz")))
    ids = torch.from_numpy(np.load(os.path.join(out, "moe_ids.npy")))
    res = {}
    for name, mesh, kw in MOE_RUNS:
        mesh_mod.init_mesh(**mesh)
        m = PipelinedGPTForCausalLM(_cfg(), n_micro=N_MICRO, device="cpu",
                                    **MOE, **kw).load_logical(w)
        step = HybridTrainStep(m, lambda mm, i: mm.loss(i),
                               AdamW(LR, parameters=m.parameters()))
        mp_ops.reset_stats()
        losses, auxs = [], []
        for _ in range(STEPS):
            losses.append(float(step(ids)))
            auxs.append(float(m.aux_loss))
        c = mesh_mod.coord()
        res[name] = {"losses": losses, "aux": auxs,
                     "coord": [c["dp"], c["pp"], c["ep"]],
                     "experts": int(m.stk_moe_w1.shape[1]),
                     "alltoall": mp_ops.stats.get("alltoall", {})}
        if name == "pp2ep2":
            Checkpointer(os.path.join(out, "ckpt"), model=m,
                         train_step=step).save(STEPS)
            np.savez(os.path.join(out, f"moe_params_r{rank}.npz"),
                     **_local_state(m))
        mesh_mod.reset_mesh()
    with open(os.path.join(out, f"moe_r{rank}.json"), "w") as f:
        json.dump(res, f)


# ---- HybridTrainStep(quant_allreduce) at dp 2 x pp 2 ----------------------

def hybrid_quant(out):
    """The reference's _hybrid_pair: gpt vocab 128, d 32, 2 layers, n_micro
    2, AdamW(1e-2), the 1F1B (6 steps) and GPipe (3 steps) schedules,
    exact and int8 dp exchanges, from one seeded model."""
    import torch

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.distributed.hybrid3d import (Hybrid3DConfig,
                                                       build_gpt3d,
                                                       init_hybrid_mesh)
    from paddle_tpu_torch.jit import HybridTrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models.gpt import GPTConfig

    D.init_parallel_env(device="cpu")
    torch.set_num_threads(1)
    cfg = GPTConfig(vocab_size=128, hidden_size=32, num_layers=2,
                    num_heads=4, max_seq_len=32)
    ids = torch.as_tensor(np.random.default_rng(1).integers(0, 128,
                                                             (4, 16)))
    res = {}
    for sched, steps in (("1f1b", 6), ("gpipe", 3)):
        for quant in (False, True):
            c = Hybrid3DConfig(dp=2, pp=2, n_micro=2, schedule=sched,
                               quant_allreduce=quant)
            mesh_mod.reset_mesh()
            init_hybrid_mesh(c)
            m = build_gpt3d(cfg, c, device="cpu", seed=0)
            step = HybridTrainStep(m, lambda mm, i: mm.loss(i),
                                   AdamW(1e-2, parameters=m.parameters()),
                                   config=c)
            losses = [float(step(ids)) for _ in range(steps)]
            res[f"{sched}/{'quant' if quant else 'exact'}"] = {
                "losses": losses, "bytes": step.comm_stats["bytes"]}
    with open(os.path.join(out, f"hybrid_quant_r{D.get_rank()}.json"),
              "w") as f:
        json.dump(res, f)


# ---- quantized_pmean on 2 or 4 ranks -----------------------------------

def quant(out):
    import torch

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.distributed import quant_collective as qc

    D.init_parallel_env(device="cpu")
    torch.set_num_threads(1)
    rank, n = D.get_rank(), D.get_world_size()
    a = dict(np.load(os.path.join(out, f"quant_inputs_{n}.npz")))
    res = {}
    for case, axes, mesh in (("dp", "dp", dict(dp=n)),
                             ("dp_sharding", ("dp", "sharding"),
                              dict(dp=2, sharding=n // 2))):
        if case == "dp_sharding" and n < 4:
            continue
        mesh_mod.init_mesh(**mesh)
        stats = {}
        res[f"{case}/x"] = qc.quantized_pmean(
            torch.from_numpy(a[f"x_r{rank}"]), axes, stats=stats).numpy()
        res[f"{case}/bytes"] = np.asarray(stats["bytes"])
        res[f"{case}/nan"] = qc.quantized_pmean(
            torch.from_numpy(a[f"nan_r{rank}"]), axes).numpy()
        tree = {"w": torch.from_numpy(a[f"w_r{rank}"]),
                "b": torch.from_numpy(a[f"b_r{rank}"]),
                "m": torch.from_numpy(a[f"m_r{rank}"]).to(torch.bfloat16)}
        got = qc.quantized_pmean_tree(tree, axes)
        for k, v in got.items():
            res[f"{case}/tree_{k}"] = v.float().numpy()
            res[f"{case}/tree_{k}_dtype"] = np.asarray(str(v.dtype))
        mesh_mod.reset_mesh()
    # the eager int8 wire: an avg all-reduce over the world
    from paddle_tpu_torch.distributed import xproc

    os.environ["PT_QUANT_ALLREDUCE"] = "1"
    res["wire/avg"] = xproc.all_reduce_np(a[f"x_r{rank}"], op="avg")
    res["wire/max"] = xproc.all_reduce_np(a[f"x_r{rank}"], op="max")
    os.environ["PT_QUANT_ALLREDUCE"] = "0"
    res.update(_quant_step(a, n))
    np.savez(os.path.join(out, f"quant_r{rank}.npz"), **res)


def quant_net(a):
    """The Linear(128, 128) of the quantized step, from the test's
    weights."""
    import torch

    net = torch.nn.Linear(128, 128)
    with torch.no_grad():
        net.weight.copy_(torch.from_numpy(a["net_w"]))
        net.bias.copy_(torch.from_numpy(a["net_b"]))
    return net


def quant_loss(m, x, y):
    return ((m(x) - y) ** 2).mean()


def _quant_step(a, n):
    """DistributedTrainStep(quant_allreduce=True) at dp n: six SGD steps
    on the global batch, and the gradient exchange's bytes."""
    import torch

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.optimizer import SGD

    mesh_mod.init_mesh(dp=n)
    net = quant_net(a)
    step = D.DistributedTrainStep(net, quant_loss,
                                  SGD(0.1, parameters=net.parameters()),
                                  quant_allreduce=True)
    x, y = torch.from_numpy(a["step_x"]), torch.from_numpy(a["step_y"])
    losses = [float(step(x, y)) for _ in range(6)]
    mesh_mod.reset_mesh()
    return {"step/losses": np.asarray(losses),
            "step/bytes": np.asarray(step.comm_stats["bytes"])}


def spawn_target(out, scale):
    """`distributed.spawn`'s worker: the gloo bring-up from the env
    contract, a world all-reduce and the gloo barrier."""
    import torch

    from paddle_tpu_torch import distributed as D

    D.init_parallel_env(device="cpu")
    t = D.all_reduce(torch.tensor([float(D.get_rank() + 1) * scale]))
    D.gloo_barrier()
    D.gloo_release()
    with open(os.path.join(out, f"spawn_r{D.get_rank()}.json"), "w") as f:
        json.dump({"sum": float(t[0]), "world": D.get_world_size(),
                   "local": os.environ["PADDLE_LOCAL_RANK"]}, f)


# ---- sequence parallelism: the ring and Ulysses attention -----------------

RING_RUNS = [("sp4", dict(sp=4)), ("sp2", dict(dp=2, sp=2))]
RING_FNS = ("ring_attention", "ring_flash_attention", "ulysses_attention")


def ring(out):
    """Each attention function on this rank's sequence shard of seeded
    q / k / v, causal and full, with the gradients of a probe loss; the
    Ulysses heads check; the sep group."""
    import torch

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.distributed import sequence_parallel as SP
    from paddle_tpu_torch.distributed.fleet.topology import (
        HybridCommunicateGroup)

    D.init_parallel_env(device="cpu")
    torch.set_num_threads(1)
    rank = D.get_rank()
    a = dict(np.load(os.path.join(out, "ring_inputs.npz")))
    res, meta = {}, {}
    for name, mesh in RING_RUNS:
        mesh_mod.init_mesh(**mesh)
        sp, idx = mesh["sp"], mesh_mod.coord()["sp"]
        s_loc = a["q"].shape[1] // sp
        cols = slice(idx * s_loc, (idx + 1) * s_loc)
        SP.stats.clear()
        for fn in RING_FNS:
            for causal in (False, True):
                q, k, v = (torch.from_numpy(a[n][:, cols]).requires_grad_()
                           for n in ("q", "k", "v"))
                o = getattr(SP, fn)(q, k, v, causal=causal)
                (o * torch.from_numpy(a["w"][:, cols])).sum().backward()
                key = f"{name}/{fn}/{int(causal)}"
                res[f"{key}/out"] = _np(o)
                for n, t in (("dq", q), ("dk", k), ("dv", v)):
                    res[f"{key}/{n}"] = _np(t.grad)
        meta[name] = {"idx": idx, "stats": {k: dict(v) for k, v in
                                            SP.stats.items()}}
        try:
            bad = torch.zeros(1, s_loc, sp + 1, 4)
            SP.ulysses_attention(bad, bad, bad)
        except ValueError as e:
            meta[name]["ulysses_error"] = str(e)
        hcg = HybridCommunicateGroup(
            dp_degree=mesh.get("dp", 1), sp_degree=sp)
        g = hcg.get_sep_parallel_group()
        meta[name]["sep"] = {"axes": list(g.axes), "nranks": g.nranks,
                             "rank": g.rank,
                             "ring": mesh_mod.global_mesh().group_ranks(
                                 ("sp",), rank)}
        mesh_mod.reset_mesh()
    np.savez(os.path.join(out, f"ring_r{rank}.npz"), **res)
    with open(os.path.join(out, f"ring_r{rank}.json"), "w") as f:
        json.dump(meta, f)


# ---- the sequence-sharded DistributedTrainStep ------------------------------

# the flat gpt_tiny case of the sequence-sharded step, and its mesh by
# world size
SEQ_CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
               max_seq_len=32)
SEQ_MESHES = {2: dict(sp=2), 4: dict(dp=2, sp=2)}


def seq_step(out):
    """`DistributedTrainStep(batch_specs=[P("dp", "sp")])` over the flat
    GPT from the reference's weights: three AdamW steps on the global
    batch; each rank writes its losses, its coordinate and its
    parameters."""
    import torch

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.convert import load_jax_state_dict
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.distributed.mesh import PartitionSpec as P
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.text.models.gpt import (GPTConfig, GPTForCausalLM,
                                                  GPTPretrainingCriterion)

    D.init_parallel_env(device="cpu")
    torch.set_num_threads(1)
    rank, world = D.get_rank(), D.get_world_size()
    mesh_mod.init_mesh(**SEQ_MESHES[world])
    m = GPTForCausalLM(GPTConfig(**SEQ_CFG), device="cpu")
    load_jax_state_dict(m, dict(np.load(os.path.join(out,
                                                      "seq_weights.npz"))))
    ids = torch.from_numpy(np.load(os.path.join(out, "seq_ids.npy")))
    crit = GPTPretrainingCriterion()
    step = D.DistributedTrainStep(
        m, lambda mm, i: crit(mm(i), i),
        AdamW(LR, parameters=m.parameters()), batch_specs=[P("dp", "sp")])
    losses = [float(step(ids)) for _ in range(STEPS)]
    c = mesh_mod.coord()
    np.savez(os.path.join(out, f"seq{world}_r{rank}.npz"),
             **{n: _np(p) for n, p in m.named_parameters()})
    with open(os.path.join(out, f"seq{world}_r{rank}.json"), "w") as f:
        json.dump({"losses": losses, "dp": c["dp"], "sp": c["sp"]}, f)
    mesh_mod.reset_mesh()


# ---- sequence parallelism inside the pipelined GPT --------------------------

SP_RUNS = [
    # (name, mesh, model kwargs, weights file)
    ("pp2sp2", dict(pp=2, sp=2), {}, "pipe"),
    ("gpipe", dict(pp=2, sp=2), dict(schedule="gpipe"), "pipe"),
    ("layer", dict(pp=2, sp=2), dict(remat="layer"), "pipe"),
    ("moe", dict(pp=2, sp=2), dict(MOE, moe_topk=1), "moe"),
]


def _sp_train(name, mesh, kw, w, ids, out, rank, res):
    import torch

    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.distributed import sequence_parallel as SP
    from paddle_tpu_torch.distributed.checkpoint import Checkpointer
    from paddle_tpu_torch.jit import HybridTrainStep
    from paddle_tpu_torch.optimizer import AdamW

    mesh_mod.init_mesh(**mesh)
    m = _model(w, **kw)
    if name == "pp2sp2":
        with torch.no_grad():
            res["eval/no_grad_loss"] = float(m.loss(ids))
        res["eval/grad_loss"] = float(m.loss(ids).detach())
        res["forward/logits_sum"] = float(m(ids[:2]).double().sum())
        m.zero_grad(set_to_none=True)
    step = HybridTrainStep(m, lambda mm, i: mm.loss(i),
                           AdamW(LR, parameters=m.parameters()))
    SP.stats.clear()
    losses, auxs = [], []
    for _ in range(STEPS):
        losses.append(float(step(ids)))
        auxs.append(float(m.aux_loss))
    c = mesh_mod.coord()
    res[name] = {"losses": losses, "aux": auxs,
                 "coord": [c["dp"], c["pp"], c["mp"], c["sp"]],
                 "ring": {k: dict(v) for k, v in SP.stats.items()}}
    if name == "pp2sp2":
        Checkpointer(os.path.join(out, "sp_ckpt"), model=m,
                     train_step=step).save(STEPS)
        np.savez(os.path.join(out, f"sp_params_r{rank}.npz"),
                 **_local_state(m))
    mesh_mod.reset_mesh()


def sp_pipe(out):
    import torch

    from paddle_tpu_torch import distributed as D

    D.init_parallel_env(device="cpu")
    torch.set_num_threads(1)
    rank = D.get_rank()
    ids = torch.from_numpy(np.load(os.path.join(out, "sp_ids.npy")))
    res = {}
    for name, mesh, kw, wfile in SP_RUNS:
        w = dict(np.load(os.path.join(out, f"{wfile}_weights.npz")))
        _sp_train(name, mesh, kw, w, ids, out, rank, res)
    with open(os.path.join(out, f"sp_pipe_r{rank}.json"), "w") as f:
        json.dump(res, f)


def sp_3d(out):
    import torch

    from paddle_tpu_torch import distributed as D

    D.init_parallel_env(device="cpu")
    torch.set_num_threads(1)
    rank = D.get_rank()
    ids = torch.from_numpy(np.load(os.path.join(out, "sp_ids.npy")))
    w = dict(np.load(os.path.join(out, "pipe_weights.npz")))
    res = {}
    _sp_train("pp2mp2sp2", dict(pp=2, mp=2, sp=2), {}, w, ids, out, rank,
              res)
    with open(os.path.join(out, f"sp_3d_r{rank}.json"), "w") as f:
        json.dump(res, f)


# ---- the auto-parallel Engine ----------------------------------------------

# the full-auto model: under the reference's ClusterSpec at batch 64 the
# planner splits the attention heads, fc1, fc2 and the head over mp 2
AUTO = dict(V=64, d=2048, nh=8, ffn=2048, batch=64, seq=4, lr=1e-4)
# the reference's ClusterSpec (a TPU v5e): the parity runs price with it
REF_CLUSTER = (197e12, 4.5e10, 16e9)


def auto_net(device="cpu"):
    """Embedding → causal MultiHeadAttention (+ residual) → fc1 / relu /
    fc2 (+ residual) → head: the port's layers under the reference's
    names (test_torch_auto_parallel builds the reference's twin)."""
    import torch

    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.nn import functional as F

    V, d, nh, ffn = AUTO["V"], AUTO["d"], AUTO["nh"], AUTO["ffn"]

    class AutoNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            kw = dict(device=device)
            self.emb = pnn.Embedding(V, d, **kw)
            self.attn = pnn.MultiHeadAttention(d, nh, **kw)
            self.fc1 = pnn.Linear(d, ffn, **kw)
            self.fc2 = pnn.Linear(ffn, d, **kw)
            self.head = pnn.Linear(d, V, **kw)

        def forward(self, ids):
            h = self.emb(ids)
            s = ids.shape[1]
            mask = torch.ones((s, s), dtype=torch.bool,
                              device=ids.device).tril()
            h = h + self.attn(h, h, h, mask)
            h = h + self.fc2(F.relu(self.fc1(h)))
            return self.head(h)

    return AutoNet()


def lm_loss(out, y):
    from paddle_tpu_torch.nn import functional as F

    return F.cross_entropy(out.reshape(-1, out.shape[-1]), y.reshape(-1))


def mlp_net():
    """The reference tests' _mlp: 16 → 32 → 8 → 4 with ReLUs."""
    from paddle_tpu_torch import nn as pnn

    return pnn.Sequential(pnn.Linear(16, 32), pnn.ReLU(), pnn.Linear(32, 8),
                          pnn.ReLU(), pnn.Linear(8, 4))


def emb_mlp_net():
    """The reference tests' _EmbMLP: Embedding(32, 8), the mean over the
    ids, four Linears."""
    import torch

    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.nn import functional as F

    class EmbMLP(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.emb = pnn.Embedding(32, 8)
            self.l1 = pnn.Linear(8, 16)
            self.l2 = pnn.Linear(16, 16)
            self.l3 = pnn.Linear(16, 8)
            self.l4 = pnn.Linear(8, 4)

        def forward(self, ids):
            h = self.emb(ids).mean(dim=1)
            h = F.relu(self.l1(h))
            h = F.relu(self.l2(h))
            h = F.relu(self.l3(h))
            return self.l4(h)

    return EmbMLP()


def _loaded(net, w):
    import torch

    with torch.no_grad():
        for n, p in net.named_parameters():
            p.copy_(torch.from_numpy(w[n]))
    return net


def _plan_record(plan):
    return {"mesh": plan.mesh, "zero": plan.zero, "cost": plan.cost,
            "bytes": plan.per_device_bytes,
            "specs": {n: list(s) for n, s in plan.param_specs.items()}}


def auto(out):
    """Four Engine runs on 2 ranks: full-auto on a live mp 2 mesh and
    with the world laid out from the plan (the reference's ClusterSpec),
    plan_tp (tensor_parallel.enable) and a partial annotation completed
    (auto_mode "semi"). Each records its fit losses; the first also its
    plan, realized units, evaluate and predict."""
    import torch

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.distributed import auto_parallel as A
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import SGD, AdamW

    D.init_parallel_env(device="cpu")
    torch.set_num_threads(1)
    rank = D.get_rank()
    a = dict(np.load(os.path.join(out, "auto_inputs.npz")))
    cluster = A.ClusterSpec(*REF_CLUSTER)
    res = {}
    batches = [(torch.from_numpy(a[f"ids{i}"]), torch.from_numpy(a[f"y{i}"]))
               for i in range(STEPS)]
    for name, live in (("full_live", True), ("full_world", False)):
        if live:
            mesh_mod.init_mesh(mp=2)
        m = _loaded(auto_net(), {k[5:]: v for k, v in a.items()
                                 if k.startswith("auto/")})
        st = A.Strategy()
        st.auto_mode = "full"
        eng = A.Engine(m, loss=lm_loss,
                       optimizer=AdamW(AUTO["lr"],
                                       parameters=m.parameters()),
                       cluster=cluster, strategy=st)
        hist = eng.fit(batches, batch_size=AUTO["batch"])
        r = {"losses": hist, "plan": _plan_record(eng.plan),
             "mesh": mesh_mod.global_mesh().shape,
             "realized": [list(u) for u in eng.realized],
             "shapes": {n: list(p.shape) for n, p in m.named_parameters()}}
        if live:
            r["eval"] = eng.evaluate([batches[0]])["loss"]
            r["pred_sum"] = float(eng.predict([(batches[0][0],)])[0]
                                  .double().sum())
        res[name] = r
        mesh_mod.reset_mesh()
    # plan_tp (tensor_parallel.enable) on the reference's _mlp
    mesh_mod.init_mesh(mp=2)
    m = _loaded(mlp_net(), {k[4:]: v for k, v in a.items()
                            if k.startswith("mlp/")})
    st = A.Strategy()
    st.tensor_parallel.enable = True
    eng = A.Engine(m, loss=F.cross_entropy,
                   optimizer=SGD(0.1, parameters=m.parameters()),
                   strategy=st)
    xy = [(torch.from_numpy(a["mlp_x"]), torch.from_numpy(a["mlp_y"]))] * 3
    res["plan_tp"] = {"losses": eng.fit(xy, batch_size=32),
                      "realized": [list(u) for u in eng.realized]}
    mesh_mod.reset_mesh()
    # a partial annotation completed (emb hidden-sharded, l2 column)
    mesh_mod.init_mesh(mp=2)
    m = _loaded(emb_mlp_net(), {k[4:]: v for k, v in a.items()
                                if k.startswith("emb/")})
    A.shard_tensor(m.emb.weight, shard_spec=[None, "mp"])
    A.shard_tensor(m.l2.weight, shard_spec=[None, "mp"])
    eng = A.Engine(m, loss=F.cross_entropy,
                   optimizer=SGD(0.1, parameters=m.parameters()))
    xy = [(torch.from_numpy(a["emb_ids"]), torch.from_numpy(a["emb_y"]))] * 5
    res["completion"] = {"losses": eng.fit(xy, batch_size=16),
                         "realized": [list(u) for u in eng.realized]}
    # reshard: whole -> this rank's columns -> whole again
    t = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    A.reshard(t, shard_spec=[None, "mp"])
    res["reshard"] = {"block": _np(t).tolist(), "spec": list(t._pspec)}
    A.reshard(t, shard_spec=[None, None])
    res["reshard"]["whole"] = _np(t).tolist()
    mesh_mod.reset_mesh()
    with open(os.path.join(out, f"auto_r{rank}.json"), "w") as f:
        json.dump(res, f)


# ---- batch norm over a data-parallel world ---------------------------------

BN_MESHES = {2: dict(dp=2), 4: dict(dp=2, sharding=2)}
BN_LAYERS = [(cls, fmt) for cls in ("BatchNorm2D", "SyncBatchNorm")
             for fmt in ("NCHW", "NHWC")]
BN_STEPS, BN_LR = 3, 1e-3


def bn(out):
    """At dp 2: each batch-norm layer of BN_LAYERS in training on this
    rank's rows of the seeded batch (output, input / weight / bias
    gradients of Σ out · gy, running statistics); at both meshes three
    Momentum steps of resnet18 under DistributedTrainStep (os_g over
    sharding). Each rank writes its results and its coordinate."""
    import torch

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.convert import export_state_dict, load_jax_state_dict
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet18

    D.init_parallel_env(device="cpu")
    torch.set_num_threads(1)
    rank, world = D.get_rank(), D.get_world_size()
    mesh_mod.init_mesh(**BN_MESHES[world])
    c = mesh_mod.coord()
    pos = c["dp"] * mesh_mod.axis_size("sharding") + c["sharding"]
    a = dict(np.load(os.path.join(out, "bn_inputs.npz")))
    res = {}
    if world == 2:
        n = a["x"].shape[0] // world
        rows = slice(pos * n, (pos + 1) * n)
        for cls, fmt in BN_LAYERS:
            layer = getattr(nn, cls)(a["x"].shape[1], data_format=fmt,
                                     device="cpu")
            with torch.no_grad():
                layer.weight.copy_(torch.from_numpy(a["w"]))
                layer.bias.copy_(torch.from_numpy(a["b"]))
            x, gy = a["x"][rows], a["gy"][rows]
            if fmt == "NHWC":
                x, gy = x.transpose(0, 2, 3, 1), gy.transpose(0, 2, 3, 1)
            x = torch.tensor(x, requires_grad=True)
            y = layer(x)
            (y * torch.from_numpy(np.ascontiguousarray(gy))).sum().backward()
            key = f"{cls}/{fmt}"
            res[f"{key}/out"] = _np(y)
            res[f"{key}/dx"] = _np(x.grad)
            res[f"{key}/dw"] = _np(layer.weight.grad)
            res[f"{key}/db"] = _np(layer.bias.grad)
            res[f"{key}/mean"] = _np(layer._mean)
            res[f"{key}/var"] = _np(layer._variance)
    m = resnet18(num_classes=10, device="cpu")
    load_jax_state_dict(m, dict(np.load(os.path.join(out, "bn_weights.npz"))))
    step = D.DistributedTrainStep(
        m, lambda mm, x, y: F.cross_entropy(mm(x), y),
        Momentum(BN_LR, parameters=m.parameters()),
        zero_level="os_g" if mesh_mod.axis_size("sharding") > 1 else None)
    x, y = torch.from_numpy(a["images"]), torch.from_numpy(a["labels"])
    losses = [float(step(x, y)) for _ in range(BN_STEPS)]
    for k, v in export_state_dict(m).items():
        res[f"resnet/{k}"] = v
    np.savez(os.path.join(out, f"bn{world}_r{rank}.npz"), **res)
    with open(os.path.join(out, f"bn{world}_r{rank}.json"), "w") as f:
        json.dump({"losses": losses, "dp": c["dp"],
                   "sharding": c["sharding"], "pos": pos}, f)
    mesh_mod.reset_mesh()


# ---- BERT at mp 2 ----------------------------------------------------------

BERT_MASKS = ("keep2d", "lengths")


def bert_mp(out):
    """bert_tiny's BertForPretraining at mp 2, each rank holding its shard
    of the whole weights: the MLM logits (its vocab columns), the NSP
    logits and the criterion's loss under each mask form."""
    import torch

    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch.convert import cut_bert_state, load_jax_state_dict
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.text.models import bert

    D.init_parallel_env(mp=2, device="cpu")
    torch.set_num_threads(1)
    rank = D.get_rank()
    cfg = bert.bert_tiny()
    m = bert.BertForPretraining(cfg, device="cpu")
    w = dict(np.load(os.path.join(out, "bert_weights.npz")))
    load_jax_state_dict(m, cut_bert_state(w, cfg, mp=2,
                                          mp_rank=mesh_mod.axis_index("mp")))
    a = {k: torch.from_numpy(v) for k, v in
         np.load(os.path.join(out, "bert_inputs.npz")).items()}
    b, s = a["ids"].shape
    lens = torch.tensor([s, 9])
    masks = {"keep2d": (torch.arange(s)[None, :] < lens[:, None]).long(),
             "lengths": lens}
    crit = bert.BertPretrainingCriterion()
    res, meta = {}, {}
    with torch.no_grad():
        for kind in BERT_MASKS:
            ml, nl = m(a["ids"], a["tt"], masks[kind])
            res[f"{kind}/mlm"] = _np(ml)
            res[f"{kind}/nsp"] = _np(nl)
            meta[f"{kind}/loss"] = float(crit(ml, a["labels"], nl, a["nsp"]))
    np.savez(os.path.join(out, f"bert_mp_r{rank}.npz"), **res)
    with open(os.path.join(out, f"bert_mp_r{rank}.json"), "w") as f:
        json.dump(meta, f)
    mesh_mod.reset_mesh()


if __name__ == "__main__":
    sys.path.insert(0, _root())
    {"mp": mp, "hybrid": hybrid, "3d": three_d, "moe": moe,
     "quant": quant, "hybrid_quant": hybrid_quant, "ring": ring,
     "sp_pipe": sp_pipe, "sp_3d": sp_3d, "seq_step": seq_step,
     "auto": auto, "bn": bn, "bert_mp": bert_mp}[sys.argv[1]](sys.argv[2])
