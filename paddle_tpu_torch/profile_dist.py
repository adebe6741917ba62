"""Data-parallel GPT training across launched processes: each rank runs
`DistributedTrainStep` on its rows of one global batch.

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node=2 \\
        --log_dir=LOG paddle_tpu_torch/profile_dist.py \\
        --model gpt_small --sharding 2 --zero os_g --steps 3 \\
        --out DIR [--ckpt CKPT_DIR] [--device cpu]

Every rank builds the model as `profile_train.bench_gpt_step` does
(`seed(0)`, random weights from seed 0, AdamW(1e-4); gpt_small under
bf16 O1 `auto_cast`, gpt_tiny in f32) and the global batch of
`--batch` x `--seq` ids from `np.random.default_rng(0)` — bench_gpt's
— and keeps its rows by its position along (dp, sharding). The world is
`--sharding` ranks on the sharding axis (ZeRO shards over it) times the
rest on dp. The flash kernels' launch counts (K3-K5,
on the card only) are set to 0 just before the steps and read just
after. With `--ckpt` the ranks then save one checkpoint of the step
(`Checkpointer.save(steps)`, each rank its own blocks).

Each rank writes DIR/dist_out_<rank>.json: the losses, each step's wall
seconds (synchronized), the gradient all-reduce's bytes and seconds per
step, the flash launches (all and tensor-core route), peak memory, and
the checkpoint files it wrote. `--device` defaults to cuda (each rank
takes `cuda:{local_rank % device_count}`: ranks may share one card);
`--device cpu` runs the plain versions.

Tensor and pipeline parallelism: `--mesh pp=2,mp=2` (any of dp, pp, mp;
their product the world size) trains `PipelinedGPTForCausalLM` instead
(weights from seed 0, each logical array drawn whole then cut, so every
mesh trains the same model; `N_MICRO` micro-batches, per-layer
recompute) through `HybridTrainStep`, under bf16 O1 for gpt_small:

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node=4 \
        --log_dir=LOG paddle_tpu_torch/profile_dist.py --model gpt_small \
        --mesh pp=2,mp=2 --batch 8 --seq 1024 --steps 3 --out DIR

and each rank's record also holds its mesh coordinate, the p2p handoffs'
and the mp all-reduces' calls, bytes and seconds per step, the tied
embedding's gradient all-reduce, and the schedule it ran (the tick
table's row of its stage); with `--ckpt` the rank also writes its
parameter shards as DIR/params_<rank>.npz, for a gather.

Mixture of experts: `--moe E` (with `--moe-topk`, `--moe-cf`; the
expert hidden size is the model's ffn_size) makes each layer's FFN a MoE
of E experts, cut over an ``ep`` axis of `--mesh` (`--mesh ep=2 --moe
4`: each rank holds 2 experts, the tokens cross by all-to-all).
`--layers` and `--n-micro` cut the depth and set the micro-batches. The
record then also holds each step's aux term and the all-to-all's calls,
bytes and seconds ("alltoall" under "mp"), and, from one no-grad pass
after the steps, this rank's tokens per expert and dropped share.
`--plant a2a_self_copy` then rebuilds the model and takes the same
steps with each all-to-all replaced by a copy of its input (a planted
fault the callers' loss gate must catch), recorded as "planted_losses".

Sequence parallelism: an ``sp`` axis in `--mesh` (`--mesh pp=2,sp=2`)
cuts every sequence over sp ranks; attention runs as the causal ring
(`distributed.sequence_parallel`: the flash ring on the card). The
record then also holds the ring's frames a step ("ring" in "comm":
"ring_p2p" calls, bytes, seconds; the forward blocks by kind), the
flash launches of the causal variant (`causal_launches`), and a digest
of this rank's parameters after the steps (sp replicas must agree).
`--plant ring_skip` / `label_unshifted` / `sp_grad_sum` (repeatable)
then rebuilds the model and takes one step with a fault planted: the
ring skips its blocks below the diagonal, the labels are shifted within
each shard instead of on the whole sequence, the gradients are not
summed over sp (the loss still is); each is recorded under "planted"
(losses and parameter digest).

`--ring-check` (run with the world as the sp ring) holds
`ring_flash_attention` over one `--ring-seq`-token causal sequence (b 1,
32 heads, head_dim 64, bf16 on the card) against the whole sequence's
flash attention in one process and against the dense f32
`ring_attention`, and records the K3-K5 launches of the ring call by
variant. `--auto` trains a GPT-shaped model of plain layers (embedding,
causal MultiHeadAttention, the MLP, an untied head; `--layers` deep)
through the auto-parallel Engine in full-auto mode over the whole world,
with the H100 `ClusterSpec`: the record holds the plan, the units it
realized, the losses and the mp collectives a step. Both run in one
launch when given together.

The int8 gradient exchange: `--quant-steps N` (data-parallel mode)
rebuilds the model after the exact steps and takes N steps of
`DistributedTrainStep(quant_allreduce=True)`, recording their losses
and the exchange's bytes and seconds ("quant"), then plants a NaN in one
gradient element on rank 0 only and records the NaN blocks each rank
decodes ("poison_blocks").
"""
import os
import sys

if __package__ in (None, ""):
    # run as a script: import the package from the checkout, not from
    # the package directory the interpreter put first on the path
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))

import argparse  # noqa: E402
import contextlib  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from paddle_tpu_torch import amp  # noqa: E402
from paddle_tpu_torch import distributed as dist  # noqa: E402
from paddle_tpu_torch.core.rng import seed  # noqa: E402
from paddle_tpu_torch.distributed import xproc  # noqa: E402
from paddle_tpu_torch.distributed.checkpoint import Checkpointer  # noqa: E402
from paddle_tpu_torch.ops.cuda_kernels import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.optimizer import AdamW  # noqa: E402
from paddle_tpu_torch.text.models.gpt import (GPTForCausalLM,  # noqa: E402
                                              GPTPretrainingCriterion,
                                              gpt_small, gpt_tiny)

MODELS = {"gpt_small": (gpt_small, True), "gpt_tiny": (gpt_tiny, False)}
# the element the poison check plants its NaN at
POISON_AT = 12345
# the mesh mode's pipeline: micro-batches a step, and the recompute policy
N_MICRO, REMAT = 4, "layer"
# faults the sequence-parallel mesh mode can plant
SP_PLANTS = ("ring_skip", "label_unshifted", "sp_grad_sum")
# --ring-check's attention: heads and head_dim (gpt_1p3b's)
RING_HEADS, RING_HD = 32, 64


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="gpt_small", choices=sorted(MODELS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sharding", type=int, default=1,
                    help="sharding axis size (dp: the rest of the world)")
    ap.add_argument("--zero", default=None,
                    choices=("os", "os_g", "p_g_os"))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint root to save the last step into")
    ap.add_argument("--out", required=True)
    ap.add_argument("--mesh", default=None,
                    help="tensor / pipeline / expert mesh, e.g. pp=2,mp=2 "
                    "or ep=2: train PipelinedGPTForCausalLM through "
                    "HybridTrainStep")
    ap.add_argument("--moe", type=int, default=0,
                    help="experts per MoE layer (0: the dense FFN)")
    ap.add_argument("--moe-topk", type=int, default=1)
    ap.add_argument("--moe-cf", type=float, default=1.25,
                    help="the MoE capacity factor")
    ap.add_argument("--layers", type=int, default=None,
                    help="decoder layers (default: the model's)")
    ap.add_argument("--n-micro", type=int, default=N_MICRO)
    ap.add_argument("--plant", default=None, action="append",
                    choices=("a2a_self_copy",) + SP_PLANTS,
                    help="a fault to plant in a rebuilt model (repeatable)")
    ap.add_argument("--ring-check", action="store_true",
                    help="hold the flash ring over the world against "
                    "whole-sequence flash attention")
    ap.add_argument("--ring-seq", type=int, default=4096)
    ap.add_argument("--auto", action="store_true",
                    help="train through the auto-parallel Engine")
    ap.add_argument("--quant-steps", type=int, default=0,
                    help="steps of the int8 gradient exchange after the "
                    "exact ones (data-parallel mode)")
    return ap.parse_args(argv)


def parse_mesh(text):
    """'pp=2,mp=2' -> {'pp': 2, 'mp': 2}."""
    out = {}
    for part in text.split(","):
        k, v = part.split("=")
        if k.strip() not in ("dp", "pp", "mp", "sp", "ep"):
            raise ValueError(f"--mesh axis {k!r}: expected dp, pp, mp, sp "
                             "or ep")
        out[k.strip()] = int(v)
    return out


def model_config(model_name, layers=None, seq=None):
    """(config, O1 or not) of `model_name`, its depth cut to `layers`,
    its position table grown to `seq` rows where it is shorter."""
    make, o1 = MODELS[model_name]
    cfg = make()
    if layers:
        cfg.num_layers = layers
    if seq and seq > cfg.max_seq_len:
        cfg.max_seq_len = seq
    return cfg, o1


def build_pipelined(model_name, device, moe=0, moe_topk=1, moe_cf=1.25,
                    layers=None, n_micro=N_MICRO, seq=None):
    """(config, HybridTrainStep) over the current mesh: the pipelined GPT
    from seed 0 (the same logical weights on every mesh), `n_micro`
    micro-batches, REMAT recompute, AdamW(1e-4), bf16 O1 for gpt_small;
    with `moe` experts a MoE FFN in every layer."""
    from paddle_tpu_torch.jit import HybridTrainStep
    from paddle_tpu_torch.text.models.gpt_pipeline import (
        PipelinedGPTForCausalLM)

    seed(0)
    cfg, o1 = model_config(model_name, layers, seq)
    model = PipelinedGPTForCausalLM(
        cfg, n_micro=n_micro, remat=REMAT, device=device, seed=0,
        moe_experts=moe, moe_topk=moe_topk, moe_capacity_factor=moe_cf)

    def loss_fn(m, ids):
        if not o1:
            return m.loss(ids)
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return m.loss(ids)

    opt = AdamW(1e-4, parameters=model.parameters())
    return cfg, HybridTrainStep(model, loss_fn, opt)


def _delta(after, before):
    out = {}
    for k, d in after.items():
        b = before.get(k, {})
        out[k] = {f: d[f] - b.get(f, 0) for f in d}
    return out


def _self_copy(x, axis="ep", kind="alltoall"):
    return x


def param_digest(model):
    """sha256 of this rank's parameters, in order (sp replicas hold the
    same bytes after the same steps)."""
    h = hashlib.sha256()
    for _, p in model.named_parameters():
        h.update(p.detach().cpu().contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def planted(name):
    """One of SP_PLANTS planted for the block's duration."""
    from paddle_tpu_torch.distributed import sequence_parallel as SP
    from paddle_tpu_torch.text.models.gpt_pipeline import (
        PipelinedGPTForCausalLM as Pipe)

    p1 = sys.modules["paddle_tpu_torch.distributed.fleet.meta_parallel."
                     "pipeline_1f1b"]
    if name == "ring_skip":
        owner, attr = SP, "_mode"
        real = SP._mode

        def fake(causal, src, idx):
            return "skipped" if src < idx else real(causal, src, idx)
    elif name == "label_unshifted":
        owner, attr = Pipe, "_sp_columns"
        real = Pipe._sp_columns

        def fake(self, ids, labels):
            s_loc = ids.shape[1] // self.sp
            start = self.sp_rank * s_loc
            lab = labels[:, start:start + s_loc]
            return (ids[:, start:start + s_loc], torch.cat(
                [lab[:, 1:], torch.full_like(lab[:, :1], -1)], 1), start)
    else:
        owner, attr = p1, "_sum_partials"
        real = p1._sum_partials

        def fake(grads, scalars, axes):
            return real([], scalars, axes)
    setattr(owner, attr, fake)
    try:
        yield
    finally:
        setattr(owner, attr, real)


def main_mesh(args):
    import copy

    from paddle_tpu_torch.distributed import moe as moe_mod
    from paddle_tpu_torch.distributed import sequence_parallel as SP
    from paddle_tpu_torch.distributed.fleet.meta_parallel import mp_ops
    from paddle_tpu_torch.distributed.mesh import coord

    p1 = sys.modules["paddle_tpu_torch.distributed.fleet.meta_parallel."
                     "pipeline_1f1b"]
    mesh = parse_mesh(args.mesh)
    dist.init_parallel_env(device=args.device, **mesh)
    rank = dist.get_rank()
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.reset_peak_memory_stats(device)
    kw = dict(moe=args.moe, moe_topk=args.moe_topk, moe_cf=args.moe_cf,
              layers=args.layers, n_micro=args.n_micro, seq=args.seq)
    t0 = time.perf_counter()
    cfg, step = build_pipelined(args.model, device, **kw)
    build_s = time.perf_counter() - t0
    ids = global_batch(cfg, args.batch, args.seq)
    fa.reset_launches()
    p1.stats.clear()
    mp_ops.reset_stats()
    SP.stats.clear()
    losses, step_s, comm, auxs = [], [], [], []
    for _ in range(args.steps):
        before = (copy.deepcopy(p1.stats), copy.deepcopy(mp_ops.stats),
                  dict(step.model.tied_stats), copy.deepcopy(SP.stats))
        _sync(device)
        t0 = time.perf_counter()
        losses.append(float(step(ids)))
        _sync(device)
        step_s.append(time.perf_counter() - t0)
        auxs.append(float(step.model.aux_loss))
        comm.append({"dp": dict(step.comm_stats),
                     "p2p": _delta(p1.stats, before[0]),
                     "mp": _delta(mp_ops.stats, before[1]),
                     "tied_wte": {k: v - before[2].get(k, 0) for k, v in
                                  step.model.tied_stats.items()},
                     "ring": _delta(SP.stats, before[3])})
    out = dict(rank=rank, model=args.model, device=str(device),
               device_name=(torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
               mesh=dist.mesh.global_mesh().shape, coord=coord(),
               n_micro=args.n_micro, remat=REMAT, batch=args.batch,
               seq=args.seq, layers=cfg.num_layers, build_s=build_s,
               losses=losses, step_seconds=step_s, comm=comm,
               schedule=[list(map(str, r)) for r in p1.last_schedule],
               launches=dict(fa.launches), tc_launches=dict(fa.tc_launches),
               causal_launches=dict(fa.causal_launches),
               param_digest=param_digest(step.model),
               peak_mb=(torch.cuda.max_memory_allocated(device) / 2**20
                        if device.type == "cuda" else None))
    if args.moe:
        m = step.model
        out.update(moe=args.moe, moe_topk=args.moe_topk,
                   moe_cf=args.moe_cf, aux=auxs,
                   experts_held=int(m.stk_moe_w1.shape[1]))
        moe_mod.route_stats = {}
        with torch.no_grad():
            m.loss(ids)
        out["routing"] = moe_mod.route_stats
        moe_mod.route_stats = None
    for plant in args.plant or ():
        step = None     # free the sound run's model first
        if plant == "a2a_self_copy":
            # the same steps of a fresh model, every all-to-all a copy
            real = mp_ops.all_to_all_mp_raw
            mp_ops.all_to_all_mp_raw = _self_copy
            try:
                _, bad = build_pipelined(args.model, device, **kw)
                out["planted_losses"] = [float(bad(ids))
                                         for _ in range(args.steps)]
            finally:
                mp_ops.all_to_all_mp_raw = real
        else:
            with planted(plant):
                _, bad = build_pipelined(args.model, device, **kw)
                losses = [float(bad(ids))]
            out.setdefault("planted", {})[plant] = {
                "losses": losses, "param_digest": param_digest(bad.model)}
        del bad
    os.makedirs(args.out, exist_ok=True)
    if args.ckpt:
        if step is None:
            raise ValueError("--ckpt with --plant: the checkpoint saves the "
                             "sound run's step, which the planted runs "
                             "replaced")
        t0 = time.perf_counter()
        ck = Checkpointer(args.ckpt, model=step.model, train_step=step)
        ck.save(args.steps)
        out["ckpt_seconds"] = time.perf_counter() - t0
        d = ck._dir(args.steps)
        out["ckpt_files"] = sorted(f for f in os.listdir(
            os.path.join(d, "shards")) if f"#r{rank}s" in f)
        np.savez(os.path.join(args.out, f"params_{rank}.npz"),
                 **{n: p.detach().float().cpu().numpy()
                    for n, p in step.model.named_parameters()})
    with open(os.path.join(args.out, f"dist_out_{rank}.json"), "w") as f:
        json.dump(out, f)
    if rank == 0:
        # the step's sequence-parallel exchanges: the ring's frames and
        # the Ulysses all-to-all (when a model uses it)
        print(json.dumps({"mesh": mesh, "s_per_step": step_s,
                          "ring": comm[-1]["ring"],
                          "ulysses_a2a": comm[-1]["mp"].get("ulysses_a2a",
                                                            {})}))
    xproc.barrier()       # no rank exits before all finished


def build(model_name, device, zero_level=None, quant_allreduce=False):
    """(config, DistributedTrainStep): bench_gpt's model and optimizer."""
    make, o1 = MODELS[model_name]
    seed(0)
    cfg = make()
    model = GPTForCausalLM(cfg, device=device, seed=0)
    crit = GPTPretrainingCriterion()

    def loss_fn(m, ids):
        if not o1:
            return crit(m(ids), ids)
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return crit(m(ids), ids)

    opt = AdamW(1e-4, parameters=model.parameters())
    return cfg, dist.DistributedTrainStep(model, loss_fn, opt,
                                          zero_level=zero_level,
                                          quant_allreduce=quant_allreduce)


def global_batch(cfg, batch, seq):
    return torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq)))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rel(got, want):
    """max |got − want| over max |want| (f32)."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


def ring_check(args, device):
    """`--ring-check`: the flash ring over the world (sp = the world
    size) on one causal sequence of `--ring-seq` tokens, b 1, RING_HEADS
    heads of RING_HD (bf16 on the card, f32 on the CPU), q / k / v and
    the output cotangent drawn from seed 0 on every rank. This rank's
    output and q / k / v gradient shards against (1) flash attention
    over the whole sequence in this process (`flash_attention_bshd`) and
    (2) the dense f32 `ring_attention` over the same ring. Records each
    error as max |diff| / max |reference|, the ring call's K3-K5
    launches (all, tensor-core, causal), its frames and seconds."""
    from paddle_tpu_torch.distributed import sequence_parallel as SP
    from paddle_tpu_torch.distributed import mesh as mesh_mod

    mesh_mod.init_mesh(sp=dist.get_world_size())
    sp, idx = mesh_mod.axis_size("sp"), mesh_mod.axis_index("sp")
    S, s_loc = args.ring_seq, args.ring_seq // sp
    cols = slice(idx * s_loc, (idx + 1) * s_loc)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    gen = torch.Generator().manual_seed(0)
    q, k, v, g = (torch.randn((1, S, RING_HEADS, RING_HD), generator=gen)
                  for _ in range(4))

    def leaves(ts, dt, sl=slice(None)):
        return [t[:, sl].to(device=device, dtype=dt).requires_grad_()
                for t in ts]

    def run(fn, ts, gg):
        out = fn(*ts, causal=True)
        out.backward(gg)
        _sync(device)
        return [out.detach()] + [t.grad for t in ts]

    # the references first (they also warm the process: its context, the
    # kernels' library), then the ring call alone, counted and timed
    whole = run(fa.flash_attention_bshd, leaves((q, k, v), dtype),
                g.to(device=device, dtype=dtype))
    whole = [t[:, cols] for t in whole]
    dense = run(SP.ring_attention, leaves((q, k, v), torch.float32, cols),
                g[:, cols].to(device=device))
    fa.reset_launches()
    SP.stats.clear()
    _sync(device)
    t0 = time.perf_counter()
    got = run(SP.ring_flash_attention, leaves((q, k, v), dtype, cols),
              g[:, cols].to(device=device, dtype=dtype))
    seconds = time.perf_counter() - t0
    counts = {"launches": dict(fa.launches),
              "tc_launches": dict(fa.tc_launches),
              "causal_launches": dict(fa.causal_launches)}
    ring = {k2: dict(v2) for k2, v2 in SP.stats.items()}
    names = ("out", "dq", "dk", "dv")
    out = {"ring_check": dict(
        counts, ring=ring, seconds=seconds, sp=sp, idx=idx, seq=S,
        heads=RING_HEADS, head_dim=RING_HD, dtype=str(dtype),
        vs_whole={n: _rel(a, b) for n, a, b in zip(names, got, whole)},
        vs_dense={n: _rel(a, b) for n, a, b in zip(names, got, dense)},
        dense_vs_whole={n: _rel(a, b) for n, a, b in
                        zip(names, dense, whole)})}
    mesh_mod.reset_mesh()
    return out


def auto_gpt(cfg, device, seed=0):
    """The full-auto arm's model: `cfg`'s widths as plain layers — the
    token and position embeddings, per layer LayerNorm → causal
    MultiHeadAttention → residual, LayerNorm → fc1 / GELU / fc2 →
    residual, a final LayerNorm and an untied head — N(0, 0.02) weights
    from `seed`, zero biases, unit LayerNorm scales."""
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.nn import functional as F

    d, nh, V = cfg.hidden_size, cfg.num_heads, cfg.vocab_size
    kw = dict(device=device)

    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.ln1 = pnn.LayerNorm(d, **kw)
            self.attn = pnn.MultiHeadAttention(d, nh, **kw)
            self.ln2 = pnn.LayerNorm(d, **kw)
            self.fc1 = pnn.Linear(d, cfg.ffn_size, **kw)
            self.fc2 = pnn.Linear(cfg.ffn_size, d, **kw)

        def forward(self, x, mask):
            h = self.ln1(x)
            x = x + self.attn(h, h, h, mask)
            return x + self.fc2(F.gelu(self.fc1(self.ln2(x))))

    class AutoGPT(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.wte = pnn.Embedding(V, d, **kw)
            self.wpe = pnn.Embedding(cfg.max_seq_len, d, **kw)
            self.blocks = torch.nn.ModuleList(
                Block() for _ in range(cfg.num_layers))
            self.ln_f = pnn.LayerNorm(d, **kw)
            self.head = pnn.Linear(d, V, **kw)

        def forward(self, ids):
            s = ids.shape[1]
            x = self.wte(ids) + self.wpe(torch.arange(s, device=ids.device))
            mask = torch.ones((s, s), dtype=torch.bool,
                              device=ids.device).tril()
            for blk in self.blocks:
                x = blk(x, mask)
            return self.head(self.ln_f(x))

    m = AutoGPT()
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for n, p in m.named_parameters():
            if p.dim() == 1:   # LayerNorm scales 1; every bias 0
                p.fill_(1.0 if n.endswith("weight") else 0.0)
            else:
                p.normal_(0.0, 0.02, generator=gen)
    return m


def lm_loss(logits, labels):
    from paddle_tpu_torch.nn import functional as F

    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                           labels.reshape(-1))


def auto_batches(cfg, batch, seq, steps):
    """`steps` (inputs, next-token labels) pairs from bench_gpt's seeded
    ids (one global batch of seq + 1 tokens, reused each step)."""
    ids = global_batch(cfg, batch, seq + 1)
    return [(ids[:, :-1], ids[:, 1:])] * steps


def main_auto(args, device):
    """`--auto`: the full-auto Engine over the world (no mesh: the plan
    lays it out), the H100 ClusterSpec, AdamW(1e-4), f32."""
    from paddle_tpu_torch.distributed import auto_parallel as A
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.distributed.fleet.meta_parallel import mp_ops

    cfg, _ = model_config(args.model, args.layers)
    seed(0)
    model = auto_gpt(cfg, device)
    st = A.Strategy()
    st.auto_mode = "full"
    eng = A.Engine(model, loss=lm_loss,
                   optimizer=AdamW(1e-4, parameters=model.parameters()),
                   strategy=st)
    batches = auto_batches(cfg, args.batch, args.seq, args.steps)
    mp_ops.reset_stats()
    losses, step_s, comm = [], [], []
    for b in batches:
        before = {k: dict(v) for k, v in mp_ops.stats.items()}
        _sync(device)
        t0 = time.perf_counter()
        losses += eng.fit([b], batch_size=args.batch)
        _sync(device)
        step_s.append(time.perf_counter() - t0)
        comm.append(_delta(mp_ops.stats, before))
    plan = eng.plan
    out = {"auto": {
        "plan": {"mesh": plan.mesh, "zero": plan.zero, "cost": plan.cost,
                 "bytes": plan.per_device_bytes,
                 "specs": {n: list(s) for n, s in
                           plan.param_specs.items()}},
        "mesh": mesh_mod.global_mesh().shape,
        "realized": [list(u) for u in eng.realized],
        "losses": losses, "step_seconds": step_s, "comm": comm,
        "layers": cfg.num_layers, "batch": args.batch, "seq": args.seq}}
    mesh_mod.reset_mesh()
    return out


def main_checks(args):
    """`--ring-check` and / or `--auto` in one launch."""
    dist.init_parallel_env(device=args.device)
    rank = dist.get_rank()
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.reset_peak_memory_stats(device)
    out = dict(rank=rank, device=str(device),
               device_name=(torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"))
    if args.ring_check:
        out.update(ring_check(args, device))
    if args.auto:
        out.update(main_auto(args, device))
    out["peak_mb"] = (torch.cuda.max_memory_allocated(device) / 2**20
                      if device.type == "cuda" else None)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"dist_out_{rank}.json"), "w") as f:
        json.dump(out, f)
    if rank == 0:
        print(json.dumps({k: out[k] for k in ("ring_check", "auto")
                          if k in out}))
    xproc.barrier()


def main(argv=None):
    args = parse_args(argv)
    if args.ring_check or args.auto:
        return main_checks(args)
    if args.mesh:
        return main_mesh(args)
    dist.init_parallel_env(sharding=args.sharding, device=args.device)
    rank = dist.get_rank()
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.reset_peak_memory_stats(device)
    cfg, step = build(args.model, device, args.zero)
    ids = global_batch(cfg, args.batch, args.seq)
    fa.reset_launches()
    losses, step_s, comm = [], [], []
    for _ in range(args.steps):
        _sync(device)
        t0 = time.perf_counter()
        losses.append(float(step(ids)))
        _sync(device)
        step_s.append(time.perf_counter() - t0)
        comm.append(dict(step.comm_stats))
    out = dict(rank=rank, model=args.model, device=str(device),
               device_name=(torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
               mesh=dist.mesh.global_mesh().shape, zero=args.zero,
               batch=args.batch, seq=args.seq, losses=losses,
               step_seconds=step_s, comm=comm,
               launches=dict(fa.launches), tc_launches=dict(fa.tc_launches),
               peak_mb=(torch.cuda.max_memory_allocated(device) / 2**20
                        if device.type == "cuda" else None))
    if args.ckpt:
        t0 = time.perf_counter()
        ck = Checkpointer(args.ckpt, model=step.model, train_step=step)
        ck.save(args.steps)
        out["ckpt_seconds"] = time.perf_counter() - t0
        d = ck._dir(args.steps)
        out["ckpt_files"] = sorted(f for f in os.listdir(
            os.path.join(d, "shards")) if f"#r{rank}s" in f)
    if args.quant_steps:
        del step
        out.update(quant_phase(args, device, ids))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"dist_out_{rank}.json"), "w") as f:
        json.dump(out, f)
    xproc.barrier()       # neither rank exits before both finished


def exchange_gap(g, axes):
    """The largest |int8 mean − exact mean| of the f32 [N] `g` over this
    rank's group along `axes`, each block's in units of its int8 step
    (the group's block absmax / 127): one axis's two rounding passes
    bound it by one step. The exact mean is taken in float64."""
    from paddle_tpu_torch.distributed import quant_collective as qc
    from paddle_tpu_torch.distributed.collective import _gather_np, axis_comm

    members, _ = axis_comm(tuple(axes))
    mat = _gather_np(g.cpu().numpy(), members).astype(np.float64)
    got = qc.quantized_pmean(g, axes).cpu().numpy().astype(np.float64)
    B = qc.DEFAULT_BLOCK
    pad = -g.numel() % B

    def blocks(a):
        a = np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)])
        return np.abs(a.reshape(a.shape[:-1] + (-1, B)))

    step = blocks(mat).max(axis=(0, 2)) / qc.QMAX
    gap = blocks(got - mat.mean(0)).max(-1)
    return float((gap / np.maximum(step, 1e-12)).max())


def quant_phase(args, device, ids):
    """`--quant-steps` steps of the int8 gradient exchange from the same
    start as the exact steps, then two checks on this rank's own first
    gradient at the final weights: the int8 mean against the exact one
    (`exchange_gap`), also with the exchange skipped (each rank keeps
    its own gradient: a planted fault the check must catch), and the NaN
    poison. {"quant": the losses, each step's seconds and the exchange's
    numbers, "exchange_gap" / "exchange_gap_planted": the gaps in int8
    steps, "poison_blocks": the NaN blocks this rank decoded}."""
    from paddle_tpu_torch.distributed import quant_collective as qc

    _, step = build(args.model, device, args.zero, quant_allreduce=True)
    losses, step_s, comm = [], [], []
    for _ in range(args.quant_steps):
        _sync(device)
        t0 = time.perf_counter()
        losses.append(float(step(ids)))
        _sync(device)
        step_s.append(time.perf_counter() - t0)
        comm.append(dict(step.comm_stats))
    # this rank's own gradient (the step's are the exchanged ones): one
    # backward of its rows at the final weights
    step.optimizer.clear_grad()
    step._loss([b.to(device) for b in step._slice_batch([ids])]).backward()
    g = next(p.grad for p in step._params if p.grad is not None).detach()
    g = g.reshape(-1).float().clone()
    axes = step._quant_axes
    gap = exchange_gap(g, axes)
    one_axis = qc._one_axis
    qc._one_axis = lambda flat, axis, block, stats: flat
    try:
        planted = exchange_gap(g, axes)
    finally:
        qc._one_axis = one_axis
    # a NaN in one element of rank 0's gradient only: every rank must
    # decode the same whole block to NaN
    if dist.get_rank() == 0:
        g[POISON_AT] = float("nan")
    red = qc.quantized_pmean(g, axes)
    bad = torch.nonzero(torch.isnan(red)).reshape(-1).cpu().numpy()
    blocks = sorted({int(i) // qc.DEFAULT_BLOCK for i in bad})
    return {"quant": {"losses": losses, "step_seconds": step_s,
                      "comm": comm, "axes": list(axes)},
            "exchange_gap": gap, "exchange_gap_planted": planted,
            "exchange_numel": g.numel(),
            "poison_blocks": blocks, "poison_nan": int(bad.size)}


if __name__ == "__main__":
    main()
