"""Semi-automatic parallelization — the auto-parallel Engine and its
cost-model planner (counterpart of
paddle_tpu/distributed/auto_parallel.py).

The reference annotates parameters with PartitionSpecs and leaves the
rest to GSPMD: XLA propagates the shardings and inserts the collectives.
The port runs one process per mesh position, so the annotation surface
and the planner are the reference's, line for line, and the Engine
realizes the chosen specs itself before it trains:

- `ProcessMesh` / `shard_tensor` / `shard_op` / `reshard`: the
  annotation surface. An annotation sets `_pspec` on a tensor, as
  `mp_layers.mark_sharding` does; `reshard` cuts or gathers this rank's
  block of an eager tensor.
- `complete_annotations`, `plan_tp`: the completion pass and the
  Megatron-pattern planner, over the model's `Linear` / `Embedding`
  layers in declaration order.
- `ClusterSpec`, `CostModel`, `Plan`, `Planner`: the analytic cost model
  and the search (outer over (dp, mp) factorizations and ZeRO, inner a
  Viterbi over the activation layout), pure Python over shapes: the same
  shapes, device count and `ClusterSpec` give the reference's `Plan`.
  `ClusterSpec`'s defaults are the H100's.
- `Engine`: fit / evaluate / predict over a `DistributedTrainStep`
  built from the annotations and the `Strategy` knobs (amp, the
  sharding stage → ZeRO level, recompute). Before it builds the step it
  realizes the specs (`realize`): each annotated layer keeps this
  rank's shard of its parameters and runs the collectives GSPMD would
  insert, from `mp_ops`' autograd pairs. A column-parallel Linear
  computes its output columns (`copy_to_mp` on its input); a
  row-parallel one takes its slice of the input (`split_mp`) and
  all-reduces its product (`allreduce_mp`); a vocab-sharded Embedding
  is the vocab-parallel lookup; an Attention unit keeps its heads (q /
  k / v column-parallel, the out projection row-parallel). Every
  unit's output is whole: a sharded output (a column-parallel Linear's,
  a hidden-sharded Embedding's) is all-gathered (`gather_mp`) where it
  leaves the unit. GSPMD sees the data flow and keeps a column output
  sharded into its row-parallel consumer; the port cannot see what the
  model does between two layers (a residual add, a norm), so it makes
  every unit exact on its own, at the price of an all-gather per
  sharded output.
"""
import functools

import numpy as np
import torch

from . import mesh as mesh_mod
from .mesh import PartitionSpec as P
from .parallel_step import DistributedTrainStep

__all__ = ["ProcessMesh", "shard_tensor", "shard_op", "Strategy",
           "Engine", "plan_tp", "complete_annotations", "reshard",
           "CostModel", "ClusterSpec", "Planner", "Plan", "realize"]


class ProcessMesh:
    """Logical device mesh view (reference process_mesh.py). Dimension
    names must be a subset of the global mesh axes: there is one process
    mesh and ProcessMesh names views into it."""

    def __init__(self, mesh=None, dim_names=None, process_ids=None):
        if dim_names is None:
            dim_names = ["dp", "mp"]
        self.dim_names = list(dim_names)
        self.shape = list(np.shape(mesh)) if mesh is not None else None

    def __repr__(self):
        return f"ProcessMesh(dim_names={self.dim_names})"


def _pspec(t):
    return getattr(t, "_pspec", None)


def shard_tensor(x, process_mesh=None, shard_spec=None):
    """Annotate `x` with a sharding (reference interface.py:27).
    shard_spec: list of mesh-axis names (or None) per tensor dim. The
    tensor keeps its whole value: `realize` (the Engine) cuts it."""
    if shard_spec is not None:
        x._pspec = P(*shard_spec)
    return x


def shard_op(op, process_mesh=None, in_shard_specs=None,
             out_shard_specs=None):
    """Annotate an op's outputs (reference interface.py shard_op): the
    first output spec is recorded on the result's `_pspec`."""

    def wrapped(*args, **kwargs):
        out = op(*args, **kwargs)
        if out_shard_specs and isinstance(out, torch.Tensor):
            out._pspec = P(*out_shard_specs[0])
        return out

    return wrapped


def reshard(x, shard_spec=None, process_mesh=None):
    """Re-distribute an eager tensor to a new sharding (reference
    auto_parallel/reshard.py Resharder): the whole value is assembled
    from the ranks' blocks under its current `_pspec`, then this rank's
    block under `shard_spec` is cut. The tensor holds that block after
    the call (its `_pspec` the new spec), and is returned."""
    from .collective import _assemble, _block

    spec = P(*shard_spec) if shard_spec is not None else P()
    val = x.detach() if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))
    if _pspec(x) is not None:
        val = _assemble(val, _pspec(x))
    block = _block(val, spec).to(val.device)
    if isinstance(x, torch.Tensor):
        with torch.no_grad():
            x.data = block
        x._pspec = spec
        return x
    return block


def _axis_of_entry(entry):
    if isinstance(entry, (tuple, list)):
        return entry[0] if entry else None
    return entry


def _sublayers(model):
    """The reference's `sublayers(include_self=True)`: the model, then
    every sublayer in declaration order."""
    return list(model.modules())


def _is(layer, kind):
    """`layer` is the port's `kind` layer (the reference tests the class
    name; torch's own Linear keeps [out, in] and is not one)."""
    from .. import nn as pnn

    return type(layer).__name__ == kind and isinstance(
        layer, getattr(pnn, kind))


def complete_annotations(model, verbose=False):
    """Dist-attr completion (reference: auto_parallel/completion.py:140
    Completer, complete_forward_annotation:756): walk the layers in
    declaration order tracking the mesh axis the flowing activation's
    feature dim is sharded on, and fill in unannotated weights with the
    placement that continues the pattern — an annotated column-parallel
    Linear [.., P(None, a)] makes the next unannotated Linear
    row-parallel [P(a, None)], its bias stays replicated, a column
    weight's bias follows P(a); an Embedding's hidden sharding
    P(None, a) seeds the same flow. Returns a list of (param_name,
    completed_spec) decisions."""
    decisions = []
    act_axis = None
    named = {id(p): n for n, p in model.named_parameters()}
    for layer in _sublayers(model):
        w = getattr(layer, "weight", None)
        b = getattr(layer, "bias", None)
        if not isinstance(w, torch.Tensor) or w.dim() != 2:
            continue
        if _is(layer, "Embedding"):
            if _pspec(w) is not None:
                spec = tuple(_pspec(w))
                act_axis = _axis_of_entry(spec[1] if len(spec) > 1
                                          else None)
            continue
        if not _is(layer, "Linear"):
            continue
        if _pspec(w) is not None:
            spec = tuple(_pspec(w)) + (None,) * (2 - len(tuple(_pspec(w))))
            col_ax = _axis_of_entry(spec[1])
            row_ax = _axis_of_entry(spec[0])
            if col_ax is not None:          # column-parallel
                if b is not None and _pspec(b) is None:
                    b._pspec = P(col_ax)
                    decisions.append((named.get(id(b), "bias"), b._pspec))
                act_axis = col_ax
            elif row_ax is not None:        # row-parallel
                act_axis = None
            continue
        # unannotated Linear: continue the flow
        din = int(w.shape[0])
        if act_axis is not None and din % mesh_mod.axis_size(act_axis) == 0:
            w._pspec = P(act_axis, None)    # row-parallel completion
            decisions.append((named.get(id(w), "weight"), w._pspec))
            act_axis = None
    if verbose:
        for name, spec in decisions:
            print(f"[completion] {name} -> {spec}")
    return decisions


def plan_tp(model, axis="mp"):
    """Megatron-pattern planner: walk Linear weights in order and shard
    alternating output/input dims over `axis` when divisible. Params
    that already carry a `_pspec` are left untouched; biases follow their
    weight's column sharding."""
    n = mesh_mod.axis_size(axis)
    if n <= 1:
        return model
    col = True
    for layer in _sublayers(model):
        w = getattr(layer, "weight", None)
        b = getattr(layer, "bias", None)
        if not isinstance(w, torch.Tensor) or w.dim() != 2:
            continue
        if not _is(layer, "Linear"):
            continue
        if _pspec(w) is not None:
            continue
        din, dout = int(w.shape[0]), int(w.shape[1])
        if col and dout % n == 0:
            w._pspec = P(None, axis)
            if b is not None and _pspec(b) is None:
                b._pspec = P(axis)
            col = False
        elif not col and din % n == 0:
            w._pspec = P(axis, None)
            col = True
    return model


# ------------------------------------------------------------ cost model

class ClusterSpec:
    """Per-device capabilities for cost estimation (reference
    auto_parallel/cluster.py). The defaults are one NVIDIA H100 80GB HBM3
    SXM at 700 W, from NVIDIA's H100 datasheet: 989e12 FLOP/s of dense
    bf16 tensor-core math, 450e9 B/s a direction over NVLink 4 (900 GB/s
    bidirectional), 80e9 bytes of HBM3. The reference's defaults are a
    TPU v5e's (197e12, 4.5e10, 16e9): pass them to reproduce its plans."""

    def __init__(self, peak_flops=989e12, ici_bandwidth=450e9,
                 hbm_capacity=80e9, collective_latency=1e-6):
        self.peak_flops = peak_flops
        # bytes/s per link direction (the device-to-device interconnect)
        self.ici_bandwidth = ici_bandwidth
        self.hbm_capacity = hbm_capacity     # bytes per device
        # fixed cost per collective launch: what makes MANY small
        # all-reduces (TP on tiny layers) lose to ONE fused gradient
        # all-reduce even when the byte counts say otherwise
        self.collective_latency = collective_latency


def _world_size():
    from . import env

    return env.get_world_size()


class CostModel:
    """Analytic placement cost model (reference: auto_parallel/
    cost_model.py + cost/ op-level comm/comp estimates). It walks the
    model's Linear / Embedding weights and prices one training step under
    a candidate placement: matmul FLOPs 6·B·Σ(din·dout) split over the
    participating axes, plus the collectives the placement implies — the
    DP gradient all-reduce 2·P·(dp−1)/dp bytes, a TP activation
    all-reduce per Megatron pair, the ZeRO all-gather. `plan()` picks the
    cheapest feasible of the standard candidates."""

    BYTES = {"float32": 4, "bfloat16": 2}

    def __init__(self, cluster=None, compute_dtype="bfloat16",
                 grad_dtype="float32"):
        self.cluster = cluster or ClusterSpec()
        self.cbytes = self.BYTES[compute_dtype]
        self.gbytes = self.BYTES[grad_dtype]

    def _model_stats(self, model):
        matmul_units = 0      # Σ din·dout over Linear weights
        widths = []           # dout of col-parallel candidates
        n_params = 0
        for layer in _sublayers(model):
            w = getattr(layer, "weight", None)
            if not isinstance(w, torch.Tensor):
                continue
            n_params += int(np.prod(w.shape))
            b = getattr(layer, "bias", None)
            if isinstance(b, torch.Tensor):
                n_params += int(np.prod(b.shape))
            if _is(layer, "Linear") and w.dim() == 2:
                din, dout = int(w.shape[0]), int(w.shape[1])
                matmul_units += din * dout
                widths.append(dout)
        tp_pairs = max(0, len(widths) // 2)
        return matmul_units, tp_pairs, widths, n_params

    def step_cost(self, model, batch_size, dp=1, mp=1, zero=False,
                  tokens_per_sample=1):
        """Estimated seconds for one train step under (dp, mp)."""
        c = self.cluster
        units, tp_pairs, widths, n_params = self._model_stats(model)
        B = batch_size * tokens_per_sample
        flops = 6.0 * B * units
        compute_s = flops / (dp * mp) / c.peak_flops
        # DP gradient all-reduce (ring): 2·(P/mp)·(dp−1)/dp, one launch
        comm = 0.0
        n_collectives = 0
        shard_params = n_params / mp
        if dp > 1:
            comm += 2.0 * shard_params * self.gbytes * (dp - 1) / dp
            n_collectives += 1
        # TP: one activation all-reduce per Megatron pair, fwd+bwd
        if mp > 1 and tp_pairs:
            act = (B / max(dp, 1)) * float(np.mean(widths)) * self.cbytes
            comm += 2.0 * 2.0 * tp_pairs * act * (mp - 1) / mp
            n_collectives += 2 * tp_pairs
        # ZeRO: param all-gather each step ≈ (P/mp)·bytes·(n−1)/n
        if zero and dp > 1:
            comm += shard_params * self.cbytes * (dp - 1) / dp
            n_collectives += 1
        comm_s = (comm / c.ici_bandwidth
                  + n_collectives * c.collective_latency)
        # compute and comm overlap imperfectly; take max + 10% of the loser
        return max(compute_s, comm_s) + 0.1 * min(compute_s, comm_s)

    def memory_per_device(self, model, dp=1, mp=1, zero=False,
                          opt_bytes_per_param=8):
        """Rough device bytes for params + grads + optimizer state under
        the placement."""
        _, _, _, n_params = self._model_stats(model)
        per = self.cbytes + self.gbytes + opt_bytes_per_param
        bytes_ = n_params * per / mp
        if zero:
            bytes_ /= max(dp, 1)
        return bytes_

    def plan(self, model, batch_size, n_devices=None, tokens_per_sample=1,
             candidates=None, hbm_capacity=None):
        """Pick the cheapest FEASIBLE placement: candidates whose
        param + grad + opt-state bytes exceed hbm_capacity are priced
        inf. Returns (best_name, {name: seconds})."""
        n = n_devices or _world_size()
        if hbm_capacity is None:
            hbm_capacity = self.cluster.hbm_capacity
        if candidates is None:
            candidates = [("dp", n, 1, False), ("dp_zero", n, 1, True)]
            for mp in (2, 4, 8):
                if n % mp == 0:
                    candidates.append((f"dp{n // mp}_mp{mp}", n // mp,
                                       mp, False))
        costs = {}
        for name, dp, mp, zero in candidates:
            if self.memory_per_device(model, dp, mp, zero) > hbm_capacity:
                costs[name] = float("inf")
                continue
            costs[name] = self.step_cost(
                model, batch_size, dp=dp, mp=mp, zero=zero,
                tokens_per_sample=tokens_per_sample)
        best = min(costs, key=costs.get)
        if costs[best] == float("inf"):
            raise RuntimeError(
                f"no candidate placement fits hbm_capacity="
                f"{hbm_capacity:.2e} bytes/device (tried "
                f"{sorted(costs)}); add devices, enable ZeRO/mp "
                "candidates, or raise the capacity")
        return best, costs


class Plan:
    """A searched placement: mesh factorization + per-param specs + ZeRO
    flag, with its estimated step cost (reference planner.py output)."""

    def __init__(self, mesh, param_specs, zero, cost, per_device_bytes):
        self.mesh = mesh                    # {"dp": d, "mp": m}
        self.param_specs = param_specs      # {param_name: PartitionSpec}
        self.zero = zero                    # None | "os_g"
        self.cost = cost                    # est. seconds / step
        self.per_device_bytes = per_device_bytes

    def __repr__(self):
        return (f"Plan(mesh={self.mesh}, zero={self.zero}, "
                f"cost={self.cost:.3e}s, "
                f"mem={self.per_device_bytes/1e9:.2f}GB, "
                f"{len(self.param_specs)} sharded params)")


class Planner:
    """Search-based placement planner (reference: auto_parallel/
    planner.py PlanSpace and tuner/ cost-guided selection).

    Two nested searches, both exact:
      * outer: enumerate (dp, mp) factorizations of the device count,
        with and without ZeRO os_g;
      * inner: per-layer sharding choices composed by dynamic
        programming over the ACTIVATION sharding state. A Linear may be
        column-parallel (activation leaves mp-sharded), row-parallel
        (consumes an mp-sharded activation, one all-reduce), or
        replicated; an Embedding may be vocab-sharded (one all-reduce) or
        replicated; a MultiHeadAttention is one unit (heads split, or
        replicated). Transition costs charge the all-gather a choice
        needs when the state carries another layout. The DP is Viterbi
        over the 2-state layout with a Pareto frontier of (cost, memory)
        per state.
    Feasibility: candidates whose per-device bytes exceed hbm_capacity
    are discarded."""

    def __init__(self, cost_model=None, axis="mp"):
        self.cm = cost_model or CostModel()
        self.axis = axis

    # ---- model walk -----------------------------------------------------
    def _layer_list(self, model):
        """Units the DP plans over: Linear, Embedding, and WHOLE
        MultiHeadAttention blocks (q / k / v are parallel branches off
        one replicated input, the out projection the row-parallel
        closer)."""
        named = {id(p): n for n, p in model.named_parameters()}
        out = []
        claimed = set()   # params owned by an attention unit
        for layer in _sublayers(model):
            if _is(layer, "MultiHeadAttention"):
                projs = [layer.q_proj, layer.k_proj, layer.v_proj]
                names = []
                w_units = 0
                for lin in projs + [layer.out_proj]:
                    claimed.add(id(lin.weight))
                    w_units += int(np.prod(lin.weight.shape))
                    names.append(named.get(id(lin.weight)))
                    if getattr(lin, "bias", None) is not None:
                        claimed.add(id(lin.bias))
                        names.append(named.get(id(lin.bias)))
                d = int(layer.embed_dim)
                out.append({
                    "kind": "Attention",
                    "shape": (d, d),
                    "heads": int(layer.num_heads),
                    "w_units": w_units,
                    "col_w": [named.get(id(p.weight)) for p in projs],
                    "col_b": [named.get(id(p.bias)) for p in projs
                              if getattr(p, "bias", None) is not None],
                    "row_w": named.get(id(layer.out_proj.weight)),
                    "names": [n for n in names if n],
                })
                continue
            w = getattr(layer, "weight", None)
            if not isinstance(w, torch.Tensor) or w.dim() != 2 \
                    or id(w) in claimed:
                continue
            kind = type(layer).__name__
            if not (_is(layer, "Linear") or _is(layer, "Embedding")):
                continue
            b = getattr(layer, "bias", None)
            out.append({
                "kind": kind,
                "shape": tuple(int(s) for s in w.shape),
                "w_name": named.get(id(w)),
                "b_name": named.get(id(b)) if isinstance(
                    b, torch.Tensor) else None,
            })
        return out

    @staticmethod
    def _unit_names(l):
        if l["kind"] == "Attention":
            return set(l["names"])
        return {n for n in (l["w_name"], l["b_name"]) if n}

    def _other_param_units(self, model, layers):
        seen = set()
        for l in layers:
            seen |= self._unit_names(l)
        total = 0
        for n, p in model.named_parameters():
            if n not in seen:
                total += int(np.prod(p.shape))
        return total

    @staticmethod
    def _tied_head(model, layers):
        """(vocab, d, emb_w_name) when the model declares embedding/LM
        head weight tying (`tie_embeddings`, the GPTConfig convention):
        the head matmul reuses the first Embedding's storage, so the DP
        prices its compute and comm but not its memory."""
        cfg = getattr(model, "config", None)
        tied = bool(getattr(model, "tie_embeddings",
                            getattr(cfg, "tie_embeddings", False)))
        if not tied:
            return None
        for l in layers:
            if l["kind"] == "Embedding":
                v, d = l["shape"]
                return (v, d, l["w_name"])
        return None

    # ---- inner DP -------------------------------------------------------
    def _search_layers(self, layers, dp, mp, B, tied=None):
        """Viterbi over activation layout state ∈ {None, axis}, keeping a
        PARETO FRONTIER of (cost, memory) per state. Returns a list of
        (cost_seconds_excluding_dp_grads, specs, per_device_param_UNITS)
        candidates."""
        c = self.cm.cluster
        ax = self.axis

        def gather_cost(units):
            # all-gather of a [B-shard, width] activation over mp
            return (units * self.cm.cbytes * (mp - 1) / mp
                    / c.ici_bandwidth + c.collective_latency)

        MAX_FRONT = 32

        def prune(cands):
            """Drop (cost, specs, mem) entries dominated on both axes."""
            cands = sorted(cands, key=lambda t: (t[0], t[2]))
            out = []
            best_mem = float("inf")
            for c in cands:
                if c[2] < best_mem - 1e-9:
                    out.append(c)
                    best_mem = c[2]
            return out[:MAX_FRONT]

        # state -> [(cost, specs_dict, per_device_units), ...] frontier
        states = {None: [(0.0, {}, 0)]}
        for l in layers:
            din, dout = l["shape"]
            act_in = (B / dp) * din
            act_out = (B / dp) * dout
            w_units = l.get("w_units", din * dout)
            nxt = {}

            def consider(state, cost, specs, mem):
                nxt.setdefault(state, []).append((cost, specs, mem))

            for state, frontier in states.items():
                for cost, specs, mem in frontier:
                    flops = 6.0 * (B / dp) * w_units * dp  # global
                    comp_rep = flops / dp / c.peak_flops   # dup. on mp
                    comp_shard = flops / (dp * mp) / c.peak_flops
                    if l["kind"] == "Attention":
                        # qkv column + out row: one all-reduce fwd/bwd
                        base = cost + (gather_cost(act_in) if state else 0)
                        consider(None, base + comp_rep, specs,
                                 mem + w_units)   # replicated
                        if mp > 1 and l["heads"] % mp == 0:
                            sh = dict(specs)
                            for n in l["col_w"]:
                                sh[n] = P(None, ax)
                            for n in l["col_b"]:
                                sh[n] = P(ax)
                            sh[l["row_w"]] = P(ax, None)
                            comm = 2 * (act_out * self.cm.cbytes
                                        * (mp - 1) / mp / c.ici_bandwidth
                                        + c.collective_latency)
                            consider(None, base + comp_shard + comm, sh,
                                     mem + w_units / mp)
                        continue
                    if l["kind"] == "Embedding":
                        # the reference prices a sharded incoming state
                        # as a gather of B/dp ids (ROADMAP §C caveat)
                        base = cost + (gather_cost(B / dp) if state else 0)
                        consider(None, base, specs, mem + w_units)
                        if mp > 1 and din % mp == 0:  # vocab must split
                            sh = dict(specs)
                            sh[l["w_name"]] = P(ax, None)
                            # masked-gather all-reduce (fwd) + bwd
                            comm = 2 * (act_out * self.cm.cbytes
                                        * (mp - 1) / mp / c.ici_bandwidth
                                        + c.collective_latency)
                            consider(None, base + comm, sh,
                                     mem + w_units / mp)
                        continue
                    # Linear — replicated weight (needs replicated input)
                    base = cost + (gather_cost(act_in) if state else 0)
                    consider(None, base + comp_rep, specs, mem + w_units)
                    if mp > 1 and dout % mp == 0:
                        # column-parallel: replicated in, sharded out
                        sh = dict(specs)
                        sh[l["w_name"]] = P(None, ax)
                        if l["b_name"]:
                            sh[l["b_name"]] = P(ax)
                        consider(ax, base + comp_shard, sh,
                                 mem + w_units / mp)
                    if mp > 1 and din % mp == 0 and state == ax:
                        # row-parallel: consumes the sharded activation,
                        # one all-reduce fwd + one bwd
                        sh = dict(specs)
                        sh[l["w_name"]] = P(ax, None)
                        comm = 2 * (act_out * self.cm.cbytes
                                    * (mp - 1) / mp / c.ici_bandwidth
                                    + c.collective_latency)
                        consider(None, cost + comp_shard + comm, sh,
                                 mem + w_units / mp)
            states = {st: prune(cands) for st, cands in nxt.items()}
        # the loss wants a replicated activation: close sharded states
        finals = []
        for state, frontier in states.items():
            for cost, specs, mem in frontier:
                if state is not None:
                    last_dout = layers[-1]["shape"][1]
                    cost = cost + gather_cost((B / dp) * last_dout)
                finals.append((cost, specs, mem))
        if tied is not None:
            # the tied LM head: a vocab-sharded embedding runs the
            # vocab-parallel head + CE, a replicated one the full matmul
            # on every mp rank
            vocab, d, emb_w = tied
            head_flops = 6.0 * (B / dp) * d * vocab
            closed = []
            for cost, specs, mem in finals:
                if specs.get(emb_w) == P(ax, None):
                    comm = 2 * ((B / dp) * self.cm.cbytes * (mp - 1)
                                / mp / c.ici_bandwidth
                                + c.collective_latency)
                    closed.append((cost + head_flops / (dp * mp)
                                   / c.peak_flops + comm, specs, mem))
                else:
                    closed.append((cost + head_flops / dp
                                   / c.peak_flops, specs, mem))
            finals = closed
        return prune(finals)

    # ---- outer search ---------------------------------------------------
    def plan(self, model, batch_size, n_devices=None, tokens_per_sample=1,
             hbm_capacity=None, verbose=False, force_mesh=None,
             allow_zero=True):
        """`force_mesh={"dp": d, "mp": m}` restricts the outer search to
        one factorization (a live mesh) while the per-layer DP still
        searches freely; allow_zero=False when the live mesh has no
        usable 'sharding' axis. `n_devices` defaults to the world size."""
        n = n_devices or _world_size()
        cap = hbm_capacity if hbm_capacity is not None else \
            self.cm.cluster.hbm_capacity
        layers = self._layer_list(model)
        if not layers:
            return Plan({"dp": n, "mp": 1}, {}, None, 0.0, 0)
        other_units = self._other_param_units(model, layers)
        B = batch_size * tokens_per_sample
        c = self.cm.cluster
        best = None
        scoreboard = {}
        if force_mesh is not None:
            pairs = [(force_mesh.get("dp", 1), force_mesh.get("mp", 1))]
        else:
            # mp: every power of two dividing the device count; dp must
            # divide the per-step batch
            mp_opts = []
            m = 1
            while m <= n:
                if n % m == 0:
                    mp_opts.append(m)
                m *= 2
            pairs = [(n // m, m) for m in mp_opts
                     if batch_size % (n // m) == 0]
            if not pairs:
                raise RuntimeError(
                    f"no (dp, mp) factorization of {n} devices has dp "
                    f"dividing batch_size={batch_size}; choose a batch "
                    f"size divisible by one of "
                    f"{sorted(n // m for m in mp_opts)}")
        cb, gb, ob = self.cm.cbytes, self.cm.gbytes, 8.0
        tied = self._tied_head(model, layers)
        for dp, mp in pairs:
            for ci, (cost0, specs, units0) in enumerate(
                    self._search_layers(layers, dp, mp, B, tied=tied)):
                if mp > 1 and not specs and force_mesh is None:
                    # an mp axis nothing is sharded over is pure
                    # replication: never a distinct plan (kept when the
                    # user pinned the mesh)
                    continue
                units = units0 + other_units
                cost = cost0
                # dp gradient all-reduce (sharded params reduce slices)
                if dp > 1:
                    cost += (2.0 * units * gb * (dp - 1) / dp
                             / c.ici_bandwidth + c.collective_latency)
                # the degree ZeRO shards over: the planned dp (it moves
                # to the 'sharding' axis), or a live mesh's sharding axis
                zdeg = dp
                if force_mesh is not None:
                    zdeg = force_mesh.get("sharding", 1)
                for zero in ((False, True)
                             if zdeg > 1 and allow_zero else (False,)):
                    # ZeRO os_g: grads + optimizer state shard over zdeg;
                    # params stay replicated
                    mem_z = (units * (cb + (gb + ob) / zdeg) if zero
                             else units * (cb + gb + ob))
                    cost_z = cost
                    if zero:  # reduce-scatter/gather traffic premium
                        cost_z += (units * cb * (zdeg - 1) / zdeg
                                   / c.ici_bandwidth
                                   + c.collective_latency)
                    name = (f"dp{dp}_mp{mp}"
                            + (f"_c{ci}" if ci else "")
                            + ("_zero" if zero else ""))
                    scoreboard[name] = (cost_z, mem_z)
                    if mem_z > cap:
                        continue
                    if best is None or cost_z < best[0]:
                        if force_mesh is not None:
                            # the LIVE mesh (dp here is dp·sharding)
                            sh_live = force_mesh.get("sharding", 1)
                            mesh = {"dp": dp // sh_live,
                                    "sharding": sh_live, "mp": mp}
                        elif zero:
                            mesh = {"dp": 1, "sharding": dp, "mp": mp}
                        else:
                            mesh = {"dp": dp, "mp": mp}
                        best = (cost_z, mem_z, mesh,
                                specs, "os_g" if zero else None)
        if best is None:
            sizes = {k: f"{v[1]:.2e}B" for k, v in scoreboard.items()}
            raise RuntimeError(
                f"no placement fits hbm_capacity={cap:.2e} bytes/device "
                f"(candidates: {sizes})")
        if verbose:
            for k, (cst, m) in sorted(scoreboard.items(),
                                      key=lambda kv: kv[1][0]):
                print(f"[planner] {k}: {cst:.3e}s {m/1e9:.2f}GB")
        cost_z, mem_z, mesh, specs, zero = best
        return Plan(mesh, specs, zero, cost_z, mem_z)

    def apply(self, plan, model):
        """Stamp the plan's specs onto the model's parameters (the Engine
        then realizes them, exactly as manual shard_tensor annotations)."""
        for name, p in model.named_parameters():
            spec = plan.param_specs.get(name)
            if spec is not None:
                shard_tensor(p, shard_spec=list(spec))
        return model


# ------------------------------------------------------------ realization

def _axes(spec, dims=2):
    s = tuple(spec or ()) + (None,) * dims
    return tuple(_axis_of_entry(e) for e in s[:dims])


def _unit_mode(kind, layer):
    """(mode, axis) of a unit under its parameters' specs: Linear "col" /
    "row" / "rep", Embedding "vocab" / "hidden" / "rep", Attention
    "heads" / "rep". An axis of size 1 shards nothing."""
    if kind == "Attention":
        cols = [_axes(_pspec(p.weight)) for p in
                (layer.q_proj, layer.k_proj, layer.v_proj)]
        row = _axes(_pspec(layer.out_proj.weight))
        ax = cols[0][1]
        if (ax is not None and all(c == (None, ax) for c in cols)
                and row == (ax, None) and mesh_mod.axis_size(ax) > 1):
            return "heads", ax
        return "rep", None
    first, second = _axes(_pspec(layer.weight))
    if kind == "Linear":
        if second is not None and mesh_mod.axis_size(second) > 1:
            return "col", second
        if first is not None and mesh_mod.axis_size(first) > 1:
            return "row", first
        return "rep", None
    if first is not None and mesh_mod.axis_size(first) > 1:
        return "vocab", first
    if second is not None and mesh_mod.axis_size(second) > 1:
        return "hidden", second
    return "rep", None


def _cut(p, dim, ax):
    """Keep this rank's block of parameter `p` along `dim` over `ax`."""
    n, r = mesh_mod.axis_size(ax), mesh_mod.axis_index(ax)
    c = p.shape[dim] // n
    spec = [None] * p.dim()
    spec[dim] = ax
    with torch.no_grad():
        p.data = p.data.narrow(dim, r * c, c).clone()
    p._pspec = P(*spec)
    p.mp_shard = True
    return r * c


def _linear_fwd(layer, x, mode, ax):
    from .fleet.meta_parallel.mp_ops import (allreduce_mp, copy_to_mp,
                                             gather_mp, split_mp)
    from ..nn import functional as F

    if mode == "col":
        return gather_mp(F.linear(copy_to_mp(x, ax), layer.weight,
                                  layer.bias), ax)
    y = allreduce_mp(F.linear(split_mp(x, ax), layer.weight), ax)
    return y if layer.bias is None else y + layer.bias


def _embedding_fwd(layer, ids, mode, ax, start):
    from .fleet.meta_parallel.mp_ops import allreduce_mp, gather_mp
    from ..nn import functional as F

    if mode == "vocab":
        li = ids - start
        miss = (li < 0) | (li >= layer.weight.shape[0])
        out = F.embedding(torch.where(miss, 0, li), layer.weight)
        return allreduce_mp(out.masked_fill(miss[..., None], 0), ax)
    return gather_mp(F.embedding(ids, layer.weight), ax)


def _attention_fwd(layer, query, key=None, value=None, attn_mask=None,
                   cache=None, ax="mp", heads=1):
    """A realized MultiHeadAttention: this rank's heads, the caches
    (`gen_cache` of the cut projections) holding them as the layer's
    do, through the layer's own `_attend`."""
    from .fleet.meta_parallel.mp_ops import allreduce_mp, copy_to_mp
    from ..nn import functional as F

    ins = {}

    def entered(t):
        # one copy_to_mp per distinct input: its gradient is summed once
        if id(t) not in ins:
            ins[id(t)] = copy_to_mp(t, ax)
        return ins[id(t)]

    def proj(lin, t):
        return layer._split_heads(F.linear(entered(t), lin.weight, lin.bias),
                                  heads)

    def out(x):
        o = layer.out_proj
        y = allreduce_mp(F.linear(x, o.weight), ax)
        return y if o.bias is None else y + o.bias

    return layer._attend(query, key, value, attn_mask, cache, proj, out)


def realize(model):
    """Cut every annotated unit of `model` to this rank's shard and give
    it the forward that runs the collectives GSPMD would insert (module
    docstring). The units are the planner's, in declaration order.
    Returns [(unit kind, mode, axis)] per unit. Idempotent: a realized
    unit is left as it is."""
    units = []
    claimed = set()
    for layer in _sublayers(model):
        if _is(layer, "MultiHeadAttention"):
            for lin in (layer.q_proj, layer.k_proj, layer.v_proj,
                        layer.out_proj):
                claimed.add(id(lin))
            units.append(("Attention", layer))
        elif id(layer) not in claimed and isinstance(
                getattr(layer, "weight", None), torch.Tensor) \
                and layer.weight.dim() == 2 and (
                    _is(layer, "Linear") or _is(layer, "Embedding")):
            units.append((type(layer).__name__, layer))
    modes = [(k, layer) + (getattr(layer, "_realized", None)
                           or _unit_mode(k, layer))
             for k, layer in units]
    tied = bool(getattr(model, "tie_embeddings", getattr(
        getattr(model, "config", None), "tie_embeddings", False)))
    out = []
    for kind, layer, mode, ax in modes:
        out.append((kind, mode, ax))
        if hasattr(layer, "_realized") or mode == "rep":
            continue
        layer._realized = (mode, ax)
        if kind == "Linear":
            if mode == "col":
                _cut(layer.weight, 1, ax)
                if layer.bias is not None:
                    _cut(layer.bias, 0, ax)
            else:
                _cut(layer.weight, 0, ax)
            layer.forward = functools.partial(_linear_fwd, layer,
                                              mode=mode, ax=ax)
        elif kind == "Embedding":
            if mode == "vocab":
                if tied:
                    raise NotImplementedError(
                        "a vocab-sharded embedding whose weight the "
                        "model's head reuses (tie_embeddings): the head "
                        "would read this rank's rows only")
                start = _cut(layer.weight, 0, ax)
            else:
                start = 0
                _cut(layer.weight, 1, ax)
            layer.forward = functools.partial(
                _embedding_fwd, layer, mode=mode, ax=ax, start=start)
        else:
            n = mesh_mod.axis_size(ax)
            for lin in (layer.q_proj, layer.k_proj, layer.v_proj):
                _cut(lin.weight, 1, ax)
                if lin.bias is not None:
                    _cut(lin.bias, 0, ax)
            _cut(layer.out_proj.weight, 0, ax)
            layer.forward = functools.partial(
                _attention_fwd, layer, ax=ax, heads=layer.num_heads // n)
    return out


class Strategy:
    """Parallelization knobs (reference auto_parallel/strategy.py)."""

    class _Toggle:
        def __init__(self, **defaults):
            self.enable = False
            for k, v in defaults.items():
                setattr(self, k, v)

    def __init__(self):
        self.amp = Strategy._Toggle(dtype="bfloat16", level="O1")
        self.sharding = Strategy._Toggle(stage=2, degree=1)
        self.recompute = Strategy._Toggle()
        self.tensor_parallel = Strategy._Toggle(degree=1)
        self.auto_mode = "semi"


_ZERO_OF_STAGE = {1: "os", 2: "os_g", 3: "p_g_os"}


def _loader(data, batch_size, shuffle=False, drop_last=False):
    """A map-style dataset (a `torch.utils.data.Dataset`) as batches of
    tensors; anything else is iterated as the batches themselves."""
    if not isinstance(data, torch.utils.data.Dataset):
        return data
    from ..core import rng

    gen = rng.next_generator(torch.device("cpu")) if shuffle else None
    return torch.utils.data.DataLoader(data, batch_size=batch_size,
                                       shuffle=shuffle, drop_last=drop_last,
                                       generator=gen)


def _device_of(model):
    p = next(iter(model.parameters()), None)
    return p.device if p is not None else torch.device("cpu")


def _to(batch, device):
    return [b.to(device) if isinstance(b, torch.Tensor)
            else torch.as_tensor(np.asarray(b), device=device)
            for b in batch]


class Engine:
    """fit / evaluate / predict over an auto-parallelized train step.
    `cluster` (a `ClusterSpec`, default the H100's) prices the full-auto
    plan."""

    def __init__(self, model=None, loss=None, optimizer=None,
                 metrics=None, cluster=None, strategy=None):
        self.model = model
        self.loss = loss
        self.optimizer = optimizer
        self.metrics = metrics or []
        self.cluster = cluster
        self.strategy = strategy or Strategy()
        self._step = None
        self.plan = None  # populated by auto_mode="full" (Planner)
        self.realized = None  # [(unit kind, mode, axis)] after the build

    def _build(self, batch_size=1):
        if self._step is not None:
            return
        st = self.strategy
        if st.auto_mode == "full":
            # fully automatic: search per-layer shardings with the
            # cost-model planner (reference planner_v2 full-auto mode)
            planner = Planner(CostModel(cluster=self.cluster))
            force = None
            allow_zero = True
            if mesh_mod.has_mesh():
                m = mesh_mod.global_mesh()
                force = {"dp": m.shape["dp"] * m.shape["sharding"],
                         "mp": m.shape["mp"],
                         "sharding": m.shape["sharding"]}
                # ZeRO lives on the 'sharding' axis: on a live mesh
                # without one, a zero plan would be a silent no-op
                allow_zero = m.shape["sharding"] > 1
            self.plan = planner.plan(self.model, batch_size,
                                     force_mesh=force,
                                     allow_zero=allow_zero)
            if not mesh_mod.has_mesh():
                mesh_mod.init_mesh(**self.plan.mesh)
            planner.apply(self.plan, self.model)
            if self.plan.zero and not st.sharding.enable:
                st.sharding.enable = True
                st.sharding.stage = 2
        elif st.tensor_parallel.enable:
            plan_tp(self.model)
        # propagate the user's partial shard_tensor annotations
        # (reference Completer — runs in every mode)
        complete_annotations(self.model)
        self.realized = realize(self.model)
        loss = self.loss

        def loss_fn(m, *batch):
            *xs, y = batch
            if st.amp.enable:
                from .. import amp as amp_mod

                # the model forward runs INSIDE auto_cast: that is where
                # the bf16 matmuls are
                with amp_mod.auto_cast(level=st.amp.level,
                                       dtype=st.amp.dtype):
                    return loss(m(*xs), y)
            return loss(m(*xs), y)

        zero = (_ZERO_OF_STAGE.get(st.sharding.stage, "os_g")
                if st.sharding.enable else None)
        self._step = DistributedTrainStep(
            self.model, loss_fn, self.optimizer, zero_level=zero,
            remat=st.recompute.enable)

    def fit(self, train_data, epochs=1, batch_size=1, steps_per_epoch=None,
            log_freq=0, verbose=0):
        """train_data: a `torch.utils.data.Dataset` (batched, shuffled,
        the last short batch dropped) or an iterable of batches. Returns
        each step's loss."""
        self._build(batch_size=batch_size)
        loader = _loader(train_data, batch_size, shuffle=True,
                         drop_last=True)
        history = []
        for ep in range(epochs):
            for i, batch in enumerate(loader):
                if steps_per_epoch and i >= steps_per_epoch:
                    break
                batch = batch if isinstance(batch, (tuple, list)) \
                    else (batch,)
                loss = self._step(*batch)
                history.append(float(loss))
                if log_freq and i % log_freq == 0 and verbose:
                    print(f"epoch {ep} step {i} loss "
                          f"{history[-1]:.4f}")
        return history

    def evaluate(self, valid_data, batch_size=1):
        loader = _loader(valid_data, batch_size)
        device = _device_of(self.model)
        total, n = 0.0, 0
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                for batch in loader:
                    *xs, y = _to(batch if isinstance(batch, (tuple, list))
                                 else (batch,), device)
                    out = self.model(*xs)
                    bs = int(y.shape[0]) if y.dim() else 1
                    # sample-weighted: a short final batch must not be
                    # over-weighted in the dataset mean
                    total += float(self.loss(out, y)) * bs
                    n += bs
        finally:
            if was_training:
                self.model.train()
        return {"loss": total / max(n, 1)}

    def predict(self, test_data, batch_size=1):
        """test_data must yield MODEL INPUTS only (no labels): every
        batch element is fed to the model."""
        loader = _loader(test_data, batch_size)
        device = _device_of(self.model)
        outs = []
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                for batch in loader:
                    xs = _to(batch if isinstance(batch, (tuple, list))
                             else (batch,), device)
                    outs.append(self.model(*xs))
        finally:
            if was_training:
                self.model.train()
        return outs
