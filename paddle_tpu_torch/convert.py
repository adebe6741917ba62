"""Weights between the JAX package and the port.

`load_jax_state_dict(model, arrays)` takes a JAX model's `state_dict()`
exported as `{name: np.ndarray}` (tied or untied LM head alike) and
COPIES each array into the port model's parameter or named buffer of the
same name: the weight-only quantized layers' int8 / packed int4
`weight_q` and f32 `w_step` are buffers, so a reference model quantized
by `quantize_model_int8` / `int4` loads into the port model quantized the
same way, code for code. It never aliases the caller's arrays
(`torch.from_numpy` would share memory with the numpy array and a later
in-place update on either side would leak into the other).
`export_state_dict(model)` goes the other way: `{name: np.ndarray}`
copies of the port model's parameters and buffers, so the two packages'
weights can be compared after training. `load_jax_optimizer_state`
carries a reference optimizer's `state_dict()` (accumulators keyed by
the reference's parameter names) onto the port's optimizer, so a run
can resume in the port where a reference run stopped.

Tensor and pipeline parallelism: `cut_pipelined_state` cuts one rank's
slice of a `PipelinedGPTForCausalLM`'s logical state dict by its mesh
coordinate and each array's placement, `gather_pipelined_state` puts
the ranks' slices back together, `cut_gpt_state` cuts an mp rank's
slice of the flat GPT's; `pipelined_to_gpt_state` /
`gpt_to_pipelined_state` carry weights between the pipelined and the
flat GPT (head-major qkv against [3, nh, hd]); `cut_bert_state` cuts an
mp rank's slice of a BERT / ERNIE model's.
"""
import numpy as np
import torch

__all__ = ["load_jax_state_dict", "export_state_dict",
           "load_jax_optimizer_state", "cut_pipelined_state",
           "gather_pipelined_state", "pipelined_to_gpt_state",
           "gpt_to_pipelined_state", "cut_gpt_state", "cut_bert_state",
           "stage_layers",
           "pipelined_holds", "pipelined_slices"]


def _state(model):
    """{name: tensor} of the model's parameters and named buffers."""
    return {**dict(model.named_parameters()), **dict(model.named_buffers())}


@torch.no_grad()
def load_jax_state_dict(model, arrays):
    params = _state(model)
    missing = sorted(set(params) - set(arrays))
    unexpected = sorted(set(arrays) - set(params))
    if missing or unexpected:
        raise KeyError(f"state_dict mismatch: missing {missing}, "
                       f"unexpected {unexpected}")
    for name, p in params.items():
        a = np.asarray(arrays[name])
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {a.shape} != {tuple(p.shape)}")
        p.copy_(torch.tensor(a, dtype=p.dtype, device=p.device))
    return model


@torch.no_grad()
def export_state_dict(model):
    """{name: np.ndarray} copies of every parameter and named buffer, on
    the host; bf16 tensors come out as float32 (numpy has no bfloat16)."""
    out = {}
    for name, p in _state(model).items():
        t = p.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[name] = t.numpy().copy()
    return out


def load_jax_optimizer_state(optimizer, model, arrays, names):
    """Load a reference `Optimizer.state_dict()` exported as `{key:
    np.ndarray}` (plus its `"@step"` int and `"LR_Scheduler"` dict) into
    the port's `optimizer` over `model`'s parameters.

    The reference keys accumulators `f"{p.name}_{acc}"` by its own
    parameter names. `names` gives them: a list in the order of the
    model's `state_dict()` keys (`[p.name for p in
    jax_model.state_dict().values()]`), or a dict {state_dict key:
    reference name}. Each is mapped to the port parameter under the
    same state_dict key and the optimizer's name for it."""
    keys = list(model.state_dict().keys())
    if not isinstance(names, dict):
        names = list(names)
        if len(names) != len(keys):
            raise ValueError(f"{len(names)} names for {len(keys)} "
                             "state_dict entries")
        names = dict(zip(keys, names))
    params = dict(model.named_parameters())
    own = {id(p): n for n, p in optimizer._params}
    out = {k: arrays[k] for k in ("@step", "LR_Scheduler") if k in arrays}
    for key, ref_name in names.items():
        p = params.get(key)
        if p is None or id(p) not in own:
            continue
        prefix = f"{ref_name}_"
        for k, v in arrays.items():
            if k.startswith(prefix) and k[len(prefix):] in \
                    optimizer._state_for(p):
                out[f"{own[id(p)]}_{k[len(prefix):]}"] = v
    optimizer.set_state_dict(out)
    return optimizer


# ---- tensor and pipeline parallel layouts ----------------------------
#
# A rank of a pp x mp mesh holds a slice of each logical array, cut by
# its coordinate and the array's placement: a column-parallel weight
# splits its last dim (out), a row-parallel one its first dim of
# [in, out], a stacked [L, ...] array its leading L by pp (with
# n_virtual > 1 a stage's rows are its chunks in round-robin order, so
# they are not contiguous), the vocab-parallel `wte` its rows.

# stacked name -> the dim of one layer's array that mp splits (None:
# replicated over mp)
PIPELINED_MP_DIM = {"ln1_w": None, "ln1_b": None, "qkv_w": 1, "qkv_b": 0,
                    "proj_w": 0, "proj_b": None, "ln2_w": None,
                    "ln2_b": None, "fc1_w": 1, "fc1_b": 0, "fc2_w": 0,
                    "fc2_b": None, "gate_w": None, "moe_w1": None,
                    "moe_b1": None, "moe_w2": None, "moe_b2": None}
# the per-layer dim cut over "ep": the MoE experts' (the gate is whole)
PIPELINED_EP_DIM = dict.fromkeys(PIPELINED_MP_DIM)
PIPELINED_EP_DIM.update(moe_w1=0, moe_b1=0, moe_w2=0, moe_b2=0)


def _as_tensor(a):
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))


def stage_layers(num_layers, pp, stage, n_virtual=1):
    """The global layer indices a stage holds, in its local order: its
    chunks v = 0..V-1 (global block v·pp + stage) one after the other."""
    V = n_virtual if pp > 1 else 1
    lc = num_layers // (pp * V)
    out = []
    for v in range(V):
        g = v * pp + stage
        out.extend(range(g * lc, (g + 1) * lc))
    return out


def pipelined_holds(name, pp, stage):
    """Whether a stage of the pipelined GPT holds parameter `name`: the
    stacked arrays everywhere, `wpe` on the first stage, `lnf_*` on the
    last, the tied `wte` on both."""
    if name.startswith("stk_") or name == "aux_loss":
        return True
    if name == "wpe":
        return stage == 0
    if name in ("lnf_w", "lnf_b"):
        return stage == pp - 1
    if name == "wte":
        return stage in (0, pp - 1)
    raise KeyError(name)


def pipelined_slices(name, shape, num_layers, pp, mp, stage, mp_rank,
                     n_virtual=1, ep=1, ep_rank=0):
    """Per dim of logical array `name` (of `shape`): the indices (a
    slice, or a list for an interleaved stack) this rank holds — its
    stage's layers, its mp columns or rows, its ep block of experts."""
    out = [slice(None)] * len(shape)
    if name.startswith("stk_"):
        rows = stage_layers(num_layers, pp, stage, n_virtual)
        out[0] = (slice(rows[0], rows[-1] + 1)
                  if rows == list(range(rows[0], rows[-1] + 1)) else rows)
        for d, n, r in ((PIPELINED_MP_DIM[name[4:]], mp, mp_rank),
                        (PIPELINED_EP_DIM[name[4:]], ep, ep_rank)):
            if d is not None:
                c = shape[1 + d] // n
                out[1 + d] = slice(r * c, (r + 1) * c)
    elif name == "wte":
        c = shape[0] // mp
        out[0] = slice(mp_rank * c, (mp_rank + 1) * c)
    return out


def _take(t, slices):
    for d, s in enumerate(slices):
        if isinstance(s, list):
            t = t.index_select(d, torch.tensor(s, device=t.device))
        elif s != slice(None):
            t = t[(slice(None),) * d + (s,)]
    return t


def cut_pipelined_state(arrays, config, pp=1, mp=1, stage=0, mp_rank=0,
                        n_virtual=1, ep=1, ep_rank=0):
    """{name: this rank's slice} of a PipelinedGPTForCausalLM's logical
    state dict (the reference's `state_dict()` as numpy arrays or
    tensors), for the rank at (`stage`, `mp_rank`, `ep_rank`) of a pp x
    mp x ep mesh; only the names that stage holds (`pipelined_holds`)."""
    out = {}
    for name, a in arrays.items():
        if not pipelined_holds(name, pp, stage):
            continue
        t = _as_tensor(a)
        out[name] = _take(t, pipelined_slices(
            name, tuple(t.shape), config.num_layers, pp, mp, stage,
            mp_rank, n_virtual, ep, ep_rank)).contiguous()
    return out


def gather_pipelined_state(shards, config, pp=1, mp=1, n_virtual=1, ep=1):
    """The inverse of `cut_pipelined_state`: {(stage, mp_rank) or (stage,
    mp_rank, ep_rank): {name: slice}} of every rank → {name: logical
    np.ndarray}."""
    out = {}
    for key, sd in sorted(shards.items()):
        stage, r, e = (tuple(key) + (0,))[:3]
        for name, a in sd.items():
            t = _as_tensor(a)
            if t.dtype == torch.bfloat16:
                t = t.float()
            shape = list(t.shape)
            if name.startswith("stk_"):
                shape[0] = config.num_layers
                for d, n in ((PIPELINED_MP_DIM[name[4:]], mp),
                             (PIPELINED_EP_DIM[name[4:]], ep)):
                    if d is not None:
                        shape[1 + d] *= n
            elif name == "wte":
                shape[0] *= mp
            if name not in out:
                out[name] = torch.zeros(shape, dtype=t.dtype)
            sl = pipelined_slices(name, shape, config.num_layers, pp, mp,
                                  stage, r, n_virtual, ep, e)
            dst = out[name]
            if isinstance(sl[0], list):
                for k, row in enumerate(sl[0]):
                    dst[(row,) + tuple(sl[1:])] = t[k]
            else:
                dst[tuple(sl)] = t
    return {k: v.numpy() for k, v in out.items()}


def _heads_major_to_flat(w, num_heads):
    """Columns of a fused qkv in [nh, 3, hd] order → [3, nh, hd]."""
    lead = w.shape[:-1]
    hd = w.shape[-1] // (3 * num_heads)
    return w.reshape(*lead, num_heads, 3, hd).transpose(-3, -2).reshape(
        *lead, 3 * num_heads * hd)


def _flat_to_heads_major(w, num_heads):
    lead = w.shape[:-1]
    hd = w.shape[-1] // (3 * num_heads)
    return w.reshape(*lead, 3, num_heads, hd).transpose(-3, -2).reshape(
        *lead, 3 * num_heads * hd)


_FLAT_NAMES = {"ln1_w": "ln1.weight", "ln1_b": "ln1.bias",
               "qkv_w": "qkv.weight", "qkv_b": "qkv.bias",
               "proj_w": "proj.weight", "proj_b": "proj.bias",
               "ln2_w": "ln2.weight", "ln2_b": "ln2.bias",
               "fc1_w": "fc1.weight", "fc1_b": "fc1.bias",
               "fc2_w": "fc2.weight", "fc2_b": "fc2.bias"}


def pipelined_to_gpt_state(arrays, config):
    """A PipelinedGPTForCausalLM's logical state dict → the flat
    `GPTForCausalLM`'s (tied head): the stacked arrays unstacked per
    layer, the head-major qkv columns put back in [3, nh, hd] order.
    Tensors stay on their device (numpy becomes CPU tensors). The flat
    GPT has no experts: a MoE model's state raises."""
    if "stk_gate_w" in arrays:
        raise ValueError(
            "pipelined_to_gpt_state: a MoE model's state (stk_gate_w, "
            "stk_moe_*) has no flat GPTForCausalLM counterpart, whose "
            "FFN is dense")
    t = {k: _as_tensor(v) for k, v in arrays.items()}
    out = {"gpt.wte.weight": t["wte"], "gpt.wpe.weight": t["wpe"],
           "gpt.ln_f.weight": t["lnf_w"], "gpt.ln_f.bias": t["lnf_b"]}
    for short, flat in _FLAT_NAMES.items():
        a = t["stk_" + short]
        if short in ("qkv_w", "qkv_b"):
            a = _heads_major_to_flat(a, config.num_heads)
        for i in range(config.num_layers):
            out[f"gpt.layers.{i}.{flat}"] = a[i]
    return out


def gpt_to_pipelined_state(arrays, config):
    """The inverse of `pipelined_to_gpt_state` (the `aux_loss` buffer
    zero)."""
    t = {k: _as_tensor(v) for k, v in arrays.items()}
    out = {"wte": t["gpt.wte.weight"], "wpe": t["gpt.wpe.weight"],
           "lnf_w": t["gpt.ln_f.weight"], "lnf_b": t["gpt.ln_f.bias"],
           "aux_loss": torch.zeros(())}
    for short, flat in _FLAT_NAMES.items():
        a = torch.stack([t[f"gpt.layers.{i}.{flat}"]
                         for i in range(config.num_layers)])
        if short in ("qkv_w", "qkv_b"):
            a = _flat_to_heads_major(a, config.num_heads)
        out["stk_" + short] = a
    return out


def cut_gpt_state(arrays, config, mp=1, mp_rank=0,
                  vocab_rows=("gpt.wte.weight",)):
    """This mp rank's slice of a flat `GPTForCausalLM`'s state dict: the
    qkv columns of its heads from each of q, k and v
    (`mp_layers.qkv_shard_columns`), fc1 columns, proj / fc2 rows, the
    vocab rows of `wte` (and the untied head's columns)."""
    from .distributed.fleet.meta_parallel.mp_layers import (
        qkv_shard_columns)

    out = {}
    d = config.hidden_size
    for name, a in arrays.items():
        t = _as_tensor(a)
        if mp > 1:
            if name.endswith("qkv.weight") or name.endswith("qkv.bias"):
                cols = qkv_shard_columns(d, config.num_heads, mp, mp_rank)
                t = t.index_select(t.dim() - 1, cols.to(t.device))
            elif name.endswith("fc1.weight") or name.endswith("fc1.bias") \
                    or name == "lm_head.weight":
                c = t.shape[-1] // mp
                t = t.narrow(t.dim() - 1, mp_rank * c, c)
            elif name.endswith("proj.weight") or name.endswith(
                    "fc2.weight") or name in vocab_rows:
                c = t.shape[0] // mp
                t = t.narrow(0, mp_rank * c, c)
        out[name] = t.contiguous()
    return out


def cut_bert_state(arrays, config, mp=1, mp_rank=0):
    """This mp rank's slice of a BERT / ERNIE model's state dict: the
    encoder layers cut as the flat GPT's (`cut_gpt_state`), the vocab
    rows of the word embedding."""
    rows = tuple(n for n in arrays if n.endswith("embeddings.word.weight"))
    return cut_gpt_state(arrays, config, mp, mp_rank, vocab_rows=rows)
