"""Pipeline-parallel GPT with Megatron tensor parallelism inside each
stage and an optional mixture-of-experts FFN (counterpart of
paddle_tpu/text/models/gpt_pipeline.py).

The decoder parameters are STACKED [L, ...] under the reference's names
(`stk_*`) and layouts. One process per mesh position holds its share:
its stage's rows of every stack (with n_virtual > 1 its chunks, round
robin) and, per array, its ``mp`` columns (qkv and fc1: column-parallel)
or rows (proj and fc2: row-parallel), LayerNorms and output biases whole.
The fused qkv is HEAD-MAJOR, [nh, 3, hd], so a contiguous column shard is
a whole number of heads with their q, k and v.

Stage 0 holds the embedding (`wte` rows of its vocab range, `wpe`); the
last stage holds the final LayerNorm and the head, which is tied to
`wte`. With stages in separate processes both hold the same mp slice of
`wte`, and their two gradients are summed over the {first, last} stage
pair of each mp index (the reference's shared-weight all-reduce; it gets
the sum from outer autodiff). At pp 1 the pair is one rank.

`loss(ids)` splits the global batch into `n_micro` micro-batches (each
dp rank keeps its rows of every micro) and runs the 1F1B schedule
(`schedule="gpipe"`: GPipe; n_virtual > 1: interleaved virtual stages;
forward-only fill-drain when grad is off). Each stage brackets its
parallel pairs with `copy_to_mp` / `allreduce_mp`, and the head is the
vocab-parallel CE. Attention goes through `F.scaled_dot_product_attention`,
i.e. the flash kernels K3-K5 on the card. `remat`: "stage" recomputes a
stage from its kept input in the backward tick, "layer" recomputes each
decoder layer (`fleet.recompute`), False keeps everything.

MoE (`moe_experts > 0`): each layer's dense FFN becomes a top-k MoE
(`moe_topk`, capacity `moe_capacity_factor`) with the stacked leaves
`gate_w` [L, d, E] and `moe_w1` / `moe_b1` / `moe_w2` / `moe_b2` [L, E,
...], their expert dim cut over ``ep``: each ep rank holds E/ep experts,
and the dense `fc*` leaves are absent. At ep 1 a layer dispatches its
whole local token set to the experts; at ep > 1 it goes through
`distributed.moe.moe_a2a_dispatch_combine` (the token all-to-all). The
gate statistics are all-reduced over every token-sharding axis (dp, sp,
ep), so the load-balancing aux is the global batch's on every rank, and
the capacity is counted per (dp, sp, ep) token group. `loss()` returns
loss + moe_aux_weight·aux and keeps aux in the `aux_loss` buffer.

Sequence parallelism (an ``sp`` axis > 1, with pp > 1 as in the
reference): each sp rank holds the whole stage and runs its own columns
of every sequence. Stage 0 embeds them with their GLOBAL positions; the
labels are shifted on the whole sequence before the cut (position t
carries token t + 1, the last position −1, masked), so no shard loses a
position at its edge. Attention runs as a causal ring over the sp group
(`distributed.sequence_parallel`): `ring_flash_attention` on the card
(K3-K5 per K/V block), the dense `ring_attention` on the CPU (the
reference's own CPU path). Each shard's loss is its masked token sum
over the global count b·(s − 1), a partial that the pipeline sums over
sp (`PipelineSpecs.sum_axes`) with the gradients; the embedding's two
weights, used outside the pipeline, sum theirs over sp as they leave
stage 0 (`copy_to_mp(w, "sp")`). A MoE layer's aux is pre-scaled by
1/sp so the sum gives it back.
"""
import torch
from torch import nn

from ... import amp
from ...core.dtype import resolve_dtype
from ...core.place import resolve_device
from ...distributed import mesh as mesh_mod
from ...distributed.fleet.meta_parallel.mp_ops import (allreduce_mp,
                                                       copy_to_mp,
                                                       gather_mp)
from ...distributed.fleet.meta_parallel.mp_layers import (
    parallel_cross_entropy, vocab_parallel_lookup)
from ...nn import functional as F
from ...nn.layer.layers import Layer
from .gpt import GPTConfig  # noqa: F401

__all__ = ["PipelinedGPTForCausalLM"]

# the per-layer arrays, in the reference's creation order, with their
# shapes as functions of (d, ffn, experts, expert hidden): the attention
# half, then the dense FFN or the MoE one
_ATTN = (("ln1_w", lambda d, f, e, h: [d]), ("ln1_b", lambda d, f, e, h: [d]),
         ("qkv_w", lambda d, f, e, h: [d, 3 * d]),
         ("qkv_b", lambda d, f, e, h: [3 * d]),
         ("proj_w", lambda d, f, e, h: [d, d]),
         ("proj_b", lambda d, f, e, h: [d]),
         ("ln2_w", lambda d, f, e, h: [d]), ("ln2_b", lambda d, f, e, h: [d]))
_DENSE = (("fc1_w", lambda d, f, e, h: [d, f]),
          ("fc1_b", lambda d, f, e, h: [f]),
          ("fc2_w", lambda d, f, e, h: [f, d]),
          ("fc2_b", lambda d, f, e, h: [d]))
_MOE = (("gate_w", lambda d, f, e, h: [d, e]),
        ("moe_w1", lambda d, f, e, h: [e, d, h]),
        ("moe_b1", lambda d, f, e, h: [e, 1, h]),
        ("moe_w2", lambda d, f, e, h: [e, h, d]),
        ("moe_b2", lambda d, f, e, h: [e, 1, d]))


def _add(a, b):
    a, b = amp.cast_inputs_for("add", (a, b))
    return a + b


def _layernorm(x, w, b):
    return F.layer_norm(x, [x.shape[-1]], w, b, 1e-5)


def _attention(q, k, v, sp):
    """Causal attention on [b, s, h, hd]: the flash kernels over the whole
    local sequence, or at sp > 1 the ring over the sp group (the flash
    ring on a CUDA tensor, the dense f32 ring on a CPU one)."""
    if sp == 1:
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)
    from ...distributed.sequence_parallel import (ring_attention,
                                                  ring_flash_attention)

    q, k, v = amp.cast_inputs_for("flash_attention", (q, k, v))
    ring = ring_flash_attention if q.is_cuda else ring_attention
    return ring(q, k, v, causal=True, axis_name="sp")


def _decoder_fwd(p, x, nh, mp=1, ep=1, moe_cf=1.25, dp=1, moe_topk=1,
                 sp=1):
    """One pre-LN decoder block as a function of its parameter dict (this
    rank's shards: qkv / fc1 column-parallel, proj / fc2 row-parallel).
    Each parallel pair enters through `copy_to_mp` and leaves through
    `allreduce_mp` (identities at mp 1); at sp > 1 `x` is this rank's
    sequence shard and attention is the ring. Returns (x, aux): the MoE
    load-balancing term (`_moe_ffn`) pre-scaled by 1/sp, 0 for the dense
    FFN."""
    b, s, d = x.shape
    nh_loc = nh // mp
    hd = d // nh
    h = _layernorm(x, p["ln1_w"], p["ln1_b"])
    qkv = F.linear(copy_to_mp(h), p["qkv_w"], p["qkv_b"])
    q, k, v = qkv.reshape(b, s, nh_loc, 3, hd).unbind(3)
    attn = _attention(q, k, v, sp).reshape(b, s, nh_loc * hd)
    x = _add(_add(x, allreduce_mp(F.linear(attn, p["proj_w"]))),
             p["proj_b"])
    h = _layernorm(x, p["ln2_w"], p["ln2_b"])
    if "gate_w" in p:
        out, aux = _moe_ffn(p, h, p["gate_w"].shape[-1], ep, moe_cf, dp,
                            moe_topk, sp)
        # aux is the global batch's value on every rank: 1/sp lets the
        # pipeline's sum over sp give it back
        return _add(x, out), aux / sp
    part = F.linear(F.gelu(F.linear(copy_to_mp(h), p["fc1_w"],
                                    p["fc1_b"]), approximate=True),
                    p["fc2_w"])
    return _add(_add(x, allreduce_mp(part)), p["fc2_b"]), 0.0


def _moe_ffn(p, h, n_experts, ep, cf=1.25, dp=1, topk=1, sp=1):
    """Top-k MoE FFN over this rank's expert shards (the reference's
    `_moe_ffn`): `moe_a2a_dispatch_combine` at every ep. At ep 1 its
    exchanges are identities, so it is the reference's dense local
    dispatch of the whole token set, one pass per round at capacity
    ceil(t·cf·k/E). The gate statistics all-reduce over every
    token-sharding axis (dp, sp, ep), so aux is the global batch's value.
    Returns (out [b, s, d], aux)."""
    from ...distributed.moe import expert_ffn, moe_a2a_dispatch_combine

    b, s, d = h.shape
    stat_axes = tuple(n for n, sz in (("dp", dp), ("sp", sp), ("ep", ep))
                      if sz > 1)

    def experts(expert_in):
        return expert_ffn(expert_in, p["moe_w1"], p["moe_b1"], p["moe_w2"],
                          p["moe_b2"], lambda t: F.gelu(t, approximate=True))

    out, aux = moe_a2a_dispatch_combine(
        h.reshape(b * s, d), p["gate_w"], experts, n_experts, ep,
        capacity_factor=cf, axis="ep", stat_axes=stat_axes or None,
        n_stat_shards=dp * sp * ep, topk=topk)
    return out.reshape(b, s, -1), aux


def _vocab_parallel_ce(sh, wte_loc, sl, mp):
    """Per-token CE over a vocab-sharded head: [N, d] @ [d, V/mp] local
    logits, the LSE reduced across mp (the reference's algorithm)."""
    logits = F.linear(copy_to_mp(sh), wte_loc.t())
    return parallel_cross_entropy(logits, sl)


class _TiedGrad(torch.autograd.Function):
    """Identity forward; backward sums the gradient over the {first, last}
    stage pair (the tied `wte`'s embedding and head uses)."""

    @staticmethod
    def forward(ctx, w, group, stats):
        ctx.group, ctx.stats = group, stats
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        import time

        from ...distributed import collective

        t0 = time.perf_counter()
        g = collective.all_reduce(g.contiguous().clone(), group=ctx.group)
        st = ctx.stats
        st["calls"] = st.get("calls", 0) + 1
        st["bytes"] = st.get("bytes", 0) + g.numel() * g.element_size()
        st["seconds"] = st.get("seconds", 0.0) + time.perf_counter() - t0
        return g, None, None


class PipelinedGPTForCausalLM(Layer):
    """GPT whose decoder parameters are stacked [num_layers, ...] and held
    by stage (pp) and by Megatron shard (mp); see the module docstring.
    `forward(ids)` returns the whole logits; `loss(ids)` runs the
    pipeline. Weights come from `seed` (each logical array drawn whole,
    then cut, so every mesh gets the same model) or from the reference's
    state dict (`convert.cut_pipelined_state`)."""

    # the reference's int8 dp all-reduce knob, recorded: in the port the
    # dp exchange is HybridTrainStep's, and its own quant_allreduce (or
    # Hybrid3DConfig's, or PT_QUANT_ALLREDUCE_XLA) quantizes it
    quant_allreduce = None

    def __init__(self, config, n_micro=4, remat="stage", n_virtual=1,
                 moe_experts=0, moe_hidden=None, moe_aux_weight=0.01,
                 moe_capacity_factor=1.25, moe_topk=1, schedule="1f1b",
                 device=None, dtype="float32", seed=0):
        super().__init__()
        if schedule not in ("1f1b", "gpipe"):
            raise ValueError(
                f"schedule={schedule!r}: expected '1f1b' or 'gpipe'")
        if schedule == "gpipe" and n_virtual != 1:
            raise ValueError(
                "interleaved virtual stages are a 1F1B refinement; "
                "gpipe runs n_virtual=1")
        if not isinstance(n_virtual, int) or n_virtual < 1:
            raise ValueError(
                f"n_virtual={n_virtual!r}: expected an int >= 1")
        if remat is True:
            remat = "stage"
        if remat not in ("stage", "layer", False):
            raise ValueError(
                f"remat={remat!r}: expected 'stage', 'layer', or False")
        self.config = config
        self.n_micro = n_micro
        self.schedule = schedule
        self.n_virtual = n_virtual
        self.remat = remat
        self.moe_experts = int(moe_experts)
        self.moe_hidden = moe_hidden or config.ffn_size
        self.moe_aux_weight = float(moe_aux_weight)
        self.moe_capacity_factor = float(moe_capacity_factor)
        self.moe_topk = int(moe_topk)
        mesh = mesh_mod.global_mesh()
        me = mesh_mod.coord()
        self.pp, self.mp = mesh.shape["pp"], mesh.shape["mp"]
        self.stage, self.mp_rank = me["pp"], me["mp"]
        self.dp = mesh.shape["dp"]
        self.sp, self.sp_rank = mesh.shape["sp"], me["sp"]
        # the experts' split: a dense model's ep ranks are replicas
        self.ep = mesh.shape["ep"] if self.moe_experts else 1
        self.ep_rank = me["ep"] if self.moe_experts else 0
        self._validate()
        device = resolve_device(device)
        dtype = resolve_dtype(dtype)
        d, L, ffn = config.hidden_size, config.num_layers, config.ffn_size
        V = n_virtual if self.pp > 1 else 1
        self._local_layers = L // (self.pp * V) * V

        def param(shape):
            return nn.Parameter(torch.empty(shape, device=device,
                                            dtype=dtype))

        first, last = self.stage == 0, self.stage == self.pp - 1
        self.wte = param([config.vocab_size // self.mp, d]) \
            if first or last else None
        self.wpe = param([config.max_seq_len, d]) if first else None
        from ...convert import PIPELINED_EP_DIM, PIPELINED_MP_DIM

        stack = self._stack()
        self._stack_names = [n for n, _ in stack]
        for name, shape in stack:
            md, ed = PIPELINED_MP_DIM[name], PIPELINED_EP_DIM[name]
            if md is not None:
                shape[md] //= self.mp
            if ed is not None:
                shape[ed] //= self.ep
            setattr(self, "stk_" + name,
                    param([self._local_layers] + shape))
        self.lnf_w = param([d]) if last else None
        self.lnf_b = param([d]) if last else None
        # the reference's specs, recorded; an mp shard is marked
        # `mp_shard` (TensorParallel's broadcast skips it)
        from ...distributed.fleet.meta_parallel.mp_layers import (
            mark_sharding)

        for name in self._stack_names:
            p = getattr(self, "stk_" + name)
            spec = ["pp"] + [None] * (p.dim() - 1)
            md, ed = PIPELINED_MP_DIM[name], PIPELINED_EP_DIM[name]
            if md is not None:
                spec[1 + md] = "mp"
            if ed is not None:
                spec[1 + ed] = "ep"
            mark_sharding(p, *spec)
            p.mp_shard = md is not None and self.mp > 1
        if self.wte is not None:
            mark_sharding(self.wte, "mp", None)
            self.wte.mp_shard = self.mp > 1
        self.register_buffer("aux_loss", torch.zeros(
            (), dtype=torch.float32, device=device))
        # the tied wte's gradient pair and its all-reduce's numbers
        self.tied_stats = {}
        self._pair = None
        from ...distributed import xproc

        if xproc.is_multiprocess():
            from ...distributed import collective

            # every gloo subgroup this model's step uses, made now, on
            # every rank in one order (a stage would otherwise make its
            # mp group at its first forward, after the previous stage's)
            for axes in (("dp",), ("pp",), ("mp",), ("sp",), ("ep",),
                         self._stat_axes()):
                if axes:
                    collective.axis_comm(axes)
            if self.pp > 1:
                self._pair = collective.new_group(
                    ranks=[0, self.pp - 1], axes=("pp",))
        self.reset_parameters(seed)

    def _stack(self):
        """[(name, logical per-layer shape)] of this model's stacked
        arrays, in the reference's creation order."""
        cfg = self.config
        args = (cfg.hidden_size, cfg.ffn_size, self.moe_experts,
                self.moe_hidden)
        return [(n, f(*args)) for n, f in
                _ATTN + (_MOE if self.moe_experts else _DENSE)]

    def _stat_axes(self):
        """The token-sharding axes the MoE gate statistics reduce over."""
        if not self.moe_experts:
            return ()
        return tuple(a for a, n in (("dp", self.dp), ("sp", self.sp),
                                    ("ep", self.ep)) if n > 1)

    def _validate(self):
        cfg = self.config
        V = self.n_virtual if self.pp > 1 else 1
        if self.pp > 1 and cfg.num_layers % (self.pp * V):
            raise ValueError(
                f"num_layers={cfg.num_layers} not divisible by "
                f"pp*n_virtual={self.pp}*{V}")
        if self.mp > 1:
            dims = [(cfg.num_heads, "num_heads"),
                    (cfg.vocab_size, "vocab_size")]
            if not self.moe_experts:
                # the dense fc pair is mp-sharded; the experts are not
                dims.append((cfg.ffn_size, "ffn_size"))
            for dim, what in dims:
                if dim % self.mp:
                    raise ValueError(
                        f"{what}={dim} not divisible by mp={self.mp}")
        if self.ep > 1 and self.moe_experts % self.ep:
            raise ValueError(
                f"moe_experts={self.moe_experts} not divisible by "
                f"ep={self.ep}")

    # ---- weights ----
    def logical_shapes(self):
        """{name: logical shape} of every parameter of the whole model."""
        cfg = self.config
        d, L = cfg.hidden_size, cfg.num_layers
        out = {"wte": [cfg.vocab_size, d], "wpe": [cfg.max_seq_len, d],
               "lnf_w": [d], "lnf_b": [d]}
        for name, shape in self._stack():
            out["stk_" + name] = [L] + shape
        return out

    def layout(self):
        """(pp, mp, stage, mp_rank, n_virtual) of this rank's share."""
        return (self.pp, self.mp, self.stage, self.mp_rank,
                self.n_virtual if self.pp > 1 else 1)

    def expert_layout(self):
        """(ep, ep_rank): the experts' split and this rank's block."""
        return self.ep, self.ep_rank

    @torch.no_grad()
    def load_logical(self, arrays):
        """Copy this rank's slice of a logical state dict (numpy arrays or
        tensors, e.g. the reference's `state_dict()`) into the model."""
        from ...convert import cut_pipelined_state

        pp, mp, stage, r, V = self.layout()
        cut = cut_pipelined_state(arrays, self.config, pp, mp, stage, r, V,
                                  ep=self.ep, ep_rank=self.ep_rank)
        own = dict(self.named_parameters())
        missing = sorted(set(own) - set(cut))
        if missing:
            raise KeyError(f"state dict is missing {missing}")
        for name, p in own.items():
            t = cut[name]
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(t.to(device=p.device, dtype=p.dtype))
        return self

    @torch.no_grad()
    def reset_parameters(self, seed=0):
        """Each logical array drawn whole from a generator of its own
        (N(0, 0.02) matrices, LayerNorm ones, zero biases), then cut to
        this rank's share: the same model on every mesh."""
        own = dict(self.named_parameters())
        dev = next(iter(own.values())).device
        arrays = {}
        for i, (name, shape) in enumerate(self.logical_shapes().items()):
            if name not in own:
                continue
            short = name[4:] if name.startswith("stk_") else name
            if short.endswith("_b") or short in ("moe_b1", "moe_b2"):
                arrays[name] = torch.zeros(shape, device=dev)
            elif short in ("ln1_w", "ln2_w", "lnf_w"):
                arrays[name] = torch.ones(shape, device=dev)
            else:
                gen = torch.Generator(device=dev)
                gen.manual_seed(int(seed) * 1000003 + i)
                arrays[name] = torch.empty(shape, device=dev).normal_(
                    0.0, 0.02, generator=gen)
        self.load_logical(arrays)

    def shard_storage(self):
        """ZeRO parameter storage composed with the pipeline: on a mesh
        with a 'sharding' axis > 1 the train step keeps each parameter's
        block over that axis between steps (p_g_os, the ZeRO placement
        policy); a no-op otherwise. Call before building the step."""
        if mesh_mod.axis_size("sharding") > 1:
            self._storage_axis = "sharding"
        return self

    # ---- pieces ----
    def _tied(self, w):
        if self._pair is None or w is None:
            return w
        return _TiedGrad.apply(w, self._pair, self.tied_stats)

    def _embed(self, ids, start=0):
        """The embedding of `ids` at positions start, start + 1, ...; at
        sp > 1 each weight's gradient is summed over sp on its way out."""
        wte = self._tied(self.wte)
        wpe = self.wpe
        if self.sp > 1:
            wte, wpe = copy_to_mp(wte, "sp"), copy_to_mp(wpe, "sp")
        if self.mp > 1:
            e = vocab_parallel_lookup(ids, wte, self.mp_rank * wte.shape[0])
        else:
            e = F.embedding(ids, wte)
        return _add(e, wpe[start:start + ids.shape[-1]])

    def _block_fn(self, with_aux=None, sp=None):
        """block(stage_params, x) over this rank's layers: x, or (x, aux
        summed over the layers) for a MoE model. `sp` (default the
        mesh's) > 1 runs attention as the ring over this rank's shard."""
        from ...distributed.fleet.recompute import recompute
        from ...distributed.sequence_parallel import ring_scope

        nh, mp = self.config.num_heads, self.mp
        with_aux = bool(self.moe_experts) if with_aux is None else with_aux
        kw = dict(ep=self.ep, moe_cf=self.moe_capacity_factor, dp=self.dp,
                  moe_topk=self.moe_topk,
                  sp=self.sp if sp is None else sp)

        def layer(p, x):
            return _decoder_fwd(p, x, nh, mp, **kw)

        per_layer = layer
        if self.remat == "layer":
            def per_layer(p, x):
                return recompute(layer, p, x)

        def block(stage_params, x):
            rows = {k: v.unbind(0) for k, v in stage_params.items()}
            aux = None
            for i in range(len(next(iter(rows.values())))):
                with ring_scope(layer=i):
                    x, a = per_layer({k: r[i] for k, r in rows.items()}, x)
                if with_aux:
                    aux = a if aux is None else aux + a
            return (x, aux) if with_aux else x

        return block

    def _loss_fn(self):
        mp, sp = self.mp, self.sp

        def per_token(sh, sl, post, reduction):
            if mp == 1:
                # the fused head CE: the [tokens, vocab] logits are never
                # kept
                return F.fused_linear_cross_entropy(
                    sh, post["wte"], sl, transpose_weight=True,
                    reduction=reduction, block_size=2048).float()
            tok = _vocab_parallel_ce(sh, post["wte"], sl, mp)
            return tok.mean() if reduction == "mean" else tok

        def loss_fn(y, labels, post):
            h = _layernorm(y, post["lnf_w"], post["lnf_b"])
            if sp == 1:
                sh = h[:, :-1].reshape(-1, h.shape[-1])
                return per_token(sh, labels[:, 1:].reshape(-1), post, "mean")
            # labels arrive pre-shifted (the last global position -1):
            # this shard's partial of the global mean, summed over sp by
            # the pipeline
            b, s_loc = labels.shape
            valid = (labels >= 0).reshape(-1)
            sl = torch.clamp(labels, min=0).reshape(-1)
            tok = per_token(h.reshape(-1, h.shape[-1]), sl, post, "none")
            return torch.where(valid, tok, 0.0).sum() / (b * (s_loc * sp - 1))

        return loss_fn

    def _stacked(self):
        V = self.n_virtual if self.pp > 1 else 1
        out = {}
        for n in self._stack_names:
            a = getattr(self, "stk_" + n)
            out[n] = a.view(V, a.shape[0] // V, *a.shape[1:]) if V > 1 \
                else a
        return out

    def _post(self):
        if self.stage != self.pp - 1:
            return {}
        return {"wte": self._tied(self.wte), "lnf_w": self.lnf_w,
                "lnf_b": self.lnf_b}

    def _micro(self, ids):
        """[B, s] → [M, rows of this dp rank, s]."""
        M = self.n_micro
        B = ids.shape[0]
        assert B % M == 0, f"batch {B} not divisible by n_micro {M}"
        mb = B // M
        dp = mesh_mod.axis_size("dp")
        x = ids.reshape(M, mb, ids.shape[-1])
        if dp > 1:
            if mb % dp:
                raise ValueError(
                    f"per-micro batch {mb} not divisible by dp={dp}; pick "
                    "batch/n_micro so each dp shard gets an equal slice")
            c = mb // dp
            r = mesh_mod.axis_index("dp")
            x = x[:, r * c:(r + 1) * c]
        return x

    def _sp_columns(self, ids, labels):
        """(ids, labels, start) of this sp rank's columns: the labels
        shifted on the whole sequence before the cut (position t carries
        token t + 1, the last position -1, masked)."""
        labels = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1],
                                                           -1)], dim=1)
        s_loc = ids.shape[1] // self.sp
        start = self.sp_rank * s_loc
        return (ids[:, start:start + s_loc],
                labels[:, start:start + s_loc], start)

    # ---- API ----
    def loss(self, input_ids, labels=None):
        """Mean LM loss through the pipeline schedule (the forward-only
        fill-drain when grad is off). At dp > 1 this dp rank's rows
        (HybridTrainStep averages the ranks' losses and gradients); at
        sp > 1 the global loss on every sp rank, the sum of the shards'
        partials (module docstring)."""
        from ...distributed.fleet.meta_parallel.pipeline_1f1b import (
            PipelineSpecs, pipeline_1f1b, pipeline_forward_loss)

        sp = self.sp
        if sp > 1 and self.pp == 1:
            # the reference: nothing annotates the sequence dim on its
            # degenerate path, so sp-fold replication would burn sp x the
            # FLOPs
            raise ValueError(
                "sequence parallelism in PipelinedGPTForCausalLM "
                "needs pp > 1 (use DistributedTrainStep with a "
                "seq-sharded batch_specs for GSPMD-only sp)")
        dev = self.stk_ln1_w.device
        ids = torch.as_tensor(input_ids, device=dev)
        labels = ids if labels is None else torch.as_tensor(labels,
                                                            device=dev)
        start = 0
        if sp > 1:
            if ids.shape[1] % sp:
                raise ValueError(
                    f"sequence length {ids.shape[1]} not divisible by "
                    f"sp={sp}")
            ids, labels, start = self._sp_columns(ids, labels)
        ids_m = self._micro(ids)
        lbl_m = self._micro(labels)
        if self.ep > 1:
            # the all-to-all dispatch cuts each shard's tokens into ep
            # groups
            toks = ids_m.shape[1] * ids_m.shape[2]
            if toks % self.ep:
                raise ValueError(
                    f"tokens per shard {toks} not divisible by ep="
                    f"{self.ep} (adjust batch/n_micro/dp/sp so each ep "
                    "group is equal)")
        if self.stage == 0:
            x_m = self._embed(ids_m, start)
        else:
            d = self.config.hidden_size
            x_m = torch.zeros(tuple(ids_m.shape) + (d,),
                              dtype=self.stk_ln1_w.dtype, device=dev)
        V = self.n_virtual if self.pp > 1 else 1
        block_fn, loss_fn = self._block_fn(), self._loss_fn()
        stacked, post = self._stacked(), self._post()
        aux_w = self.moe_aux_weight if self.moe_experts else None
        specs = PipelineSpecs(sum_axes=("sp",)) if sp > 1 else None
        if not torch.is_grad_enabled() and V == 1:
            out = pipeline_forward_loss(block_fn, loss_fn, stacked, post,
                                        (x_m, lbl_m), specs=specs,
                                        aux_weight=aux_w)
        else:
            remat = self.remat == "stage"
            if self.schedule == "gpipe" and self.pp > 1:
                from ...distributed.hybrid3d.schedule import pipeline_gpipe

                out = pipeline_gpipe(block_fn, loss_fn, stacked, post,
                                     (x_m, lbl_m), remat=remat,
                                     specs=specs, aux_weight=aux_w,
                                     aux_dp=self.dp)
            else:
                # HybridTrainStep averages the gradients over dp after
                # the pipeline: aux_dp scales the aux's seed for it
                out = pipeline_1f1b(block_fn, loss_fn, stacked, post,
                                    (x_m, lbl_m), remat=remat,
                                    num_virtual=V, specs=specs,
                                    aux_weight=aux_w, aux_dp=self.dp)
        if aux_w is None:
            return out
        # the pipeline returns (loss + aux_weight·aux, aux): the aux is a
        # detached metric kept in the buffer
        total, aux = out
        self.aux_loss.copy_(aux.detach().reshape(()))
        return total

    @torch.no_grad()
    def forward(self, input_ids):
        """Whole logits [b, s, vocab] on every rank (the eval path): the
        batch through the stages as one micro-batch, the head on the last
        stage, gathered over mp and summed over pp. At sp > 1 every sp
        rank runs the whole sequence (the reference's serial forward)."""
        from ...distributed.fleet.meta_parallel.mp_ops import (
            all_reduce_mp_raw)
        from ...distributed.fleet.meta_parallel.pipeline_1f1b import (
            fill_drain, pp_world)

        dev = self.stk_ln1_w.device
        ids = torch.as_tensor(input_ids, device=dev)
        block = self._block_fn(with_aux=False, sp=1)
        stacked = self._stacked()
        V = self.n_virtual if self.pp > 1 else 1

        def stage_fn(p, x):
            for v in range(V):
                x = block({k: a[v] for k, a in p.items()} if V > 1 else p,
                          x)
            return x

        pp, stage, members = pp_world()
        b, s = ids.shape
        x = self._embed(ids) if stage == 0 else torch.zeros(
            (b, s, self.config.hidden_size), dtype=self.stk_ln1_w.dtype,
            device=dev)
        if pp == 1:
            outs = [stage_fn(stacked, x)]
        elif V > 1:
            raise NotImplementedError(
                "forward of an interleaved model across stages: the "
                "fill-drain runs one chunk a stage (use loss)")
        else:
            outs = fill_drain(stage_fn, stacked, x[None], stage, pp,
                              members)
        logits = torch.zeros((b, s, self.config.vocab_size),
                             dtype=torch.float32, device=dev)
        if stage == pp - 1:
            h = _layernorm(outs[0], self.lnf_w, self.lnf_b)
            logits = gather_mp(F.linear(h, self.wte.t())).float()
        return all_reduce_mp_raw(logits, axis="pp", kind="pp_logits") \
            if pp > 1 else logits
