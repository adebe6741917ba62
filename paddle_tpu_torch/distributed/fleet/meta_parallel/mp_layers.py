"""Megatron tensor-parallel layers (counterpart of
paddle_tpu/distributed/fleet/meta_parallel/mp_layers.py).

The reference holds each whole logical weight with a PartitionSpec and
lets GSPMD insert the collectives. The port runs one process per mesh
position, so each layer holds THIS RANK'S SHARD of its weight, cut by its
coordinate on the ``mp`` mesh axis at construction, and makes the
collectives explicit through the pairs of `mp_ops`:

- `ColumnParallelLinear`: weight [in, out/mp] and bias [out/mp]; the
  input enters through `copy_to_mp`; `gather_output` all-gathers the
  output's last dim.
- `RowParallelLinear`: weight [in/mp, out]; `input_is_parallel=False`
  splits the input's last dim; the partial products go through
  `allreduce_mp`, then the whole bias is added once.
- `VocabParallelEmbedding`: rows [vocab/mp, dim], this rank's vocab
  range; ids outside it look up zeros, and the rows are all-reduced.
- `ParallelCrossEntropy`: the vocab-parallel softmax CE over the local
  logits (a max all-reduce on detached logits, a sum-exp all-reduce, the
  target logit picked where it is local and all-reduced).

At mp 1 (one process, or a mesh whose mp axis has size 1) each layer is
its plain counterpart, with the JAX package's parameter layout. A shard
is marked `mp_shard` (paddle calls it `is_distributed`, a method name
on a torch tensor): the mp broadcasts skip it.
`mark_sharding` / `shard_activation` record a spec and place nothing:
the shards are already local.

The fused qkv of the flat `GPTForCausalLM` is ordered [3, nh, hd] (q, k,
v outermost), so a contiguous column shard would cross the q / k / v
boundary: at mp > 1 each rank takes its heads from each of q, k and v
(`qkv_shard_columns`). The pipelined GPT orders it head-major,
[nh, 3, hd], where a contiguous shard is right.
"""
import torch
from torch import nn

from .... import amp
from ....nn import functional as F
from ....nn.functional import cross_entropy
from ....nn.layer.common import Embedding, Linear
from ....nn.layer.layers import Layer
from ... import mesh as mesh_mod
from .mp_ops import (all_reduce_mp_raw, allreduce_mp, copy_to_mp,
                     gather_mp, mp_world, split_mp)

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "mark_sharding",
           "shard_activation", "split_fused_qkv", "qkv_shard_columns",
           "parallel_cross_entropy", "mp_degree", "load_full"]


def mp_degree():
    """(mp size, this rank's mp coordinate) from the global mesh."""
    return mesh_mod.axis_size("mp"), mesh_mod.axis_index("mp")


def _per_rank(n, what, size):
    if size % n:
        raise ValueError(f"{what}={size} not divisible by mp={n}")
    return size // n


def mark_sharding(param, *spec):
    """Record a PartitionSpec on a parameter; the port's shards are
    already local, so nothing is placed."""
    param._pspec = mesh_mod.PartitionSpec(*spec)
    return param


def shard_activation(x, *spec):
    """A layout hint in the reference (with_sharding_constraint); each
    rank already holds its block here, so `x` itself."""
    return x


def split_fused_qkv(qkv, batch, seq, num_heads, head_dim):
    """[b, s, 3·d] fused qkv → (q, k, v), each [b, s, nh, hd]. The fused
    layout is [b, s, 3, nh, hd] — q, k, v outermost, then heads — as in
    the JAX package; a split in another order keeps every shape and
    gives wrong attention. At mp > 1 pass this rank's head count."""
    qkv = qkv.reshape(batch, seq, 3, num_heads, head_dim)
    return qkv.unbind(2)


def qkv_shard_columns(hidden, num_heads, mp, rank):
    """Column indices of the flat GPT's whole fused qkv ([.., 3·hidden],
    [3, nh, hd] order) that rank `rank` of `mp` holds: its nh/mp heads
    of each of q, k and v, three strided runs kept in [3, nh/mp, hd]
    order. (In the pipelined GPT's head-major [nh, 3, hd] layout a
    rank's heads are one contiguous run: `convert.cut_pipelined_state`.)"""
    hd = hidden // num_heads
    nl = _per_rank(mp, "num_heads", num_heads)
    cols = torch.arange(3 * hidden).reshape(3, num_heads, hd)
    return cols[:, rank * nl:(rank + 1) * nl].reshape(-1)


def vocab_parallel_lookup(ids, weight, vocab_start):
    """Rows of `ids` from this rank's vocab range [vocab_start,
    vocab_start + rows of `weight`): ids outside it look up zeros, then
    the rows are all-reduced over mp."""
    li = ids - vocab_start
    miss = (li < 0) | (li >= weight.shape[0])
    out = F.embedding(torch.where(miss, 0, li), weight)
    return allreduce_mp(out.masked_fill(miss[..., None], 0))


class VocabParallelEmbedding(Embedding):
    """Embedding whose rows are this rank's vocab range
    [rank·V/mp, (rank+1)·V/mp): a masked lookup, then an all-reduce."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, device=None, dtype=None):
        n, r = mp_degree()
        per = _per_rank(n, "vocab_size", num_embeddings)
        super().__init__(per, embedding_dim, device=device, dtype=dtype)
        self.num_embeddings = num_embeddings
        self.world_size = n
        self.vocab_start = r * per
        self.weight.mp_shard = n > 1

    def forward(self, x):
        if self.world_size == 1:
            return super().forward(x)
        return vocab_parallel_lookup(x, self.weight, self.vocab_start)


class ColumnParallelLinear(Linear):
    """Linear over this rank's output columns. gather_output=False leaves
    the output column-sharded for a following RowParallelLinear."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, device=None, dtype=None):
        n, r = mp_degree()
        super().__init__(in_features,
                         _per_rank(n, "out_features", out_features),
                         has_bias=has_bias is None or bool(has_bias),
                         device=device, dtype=dtype)
        self.gather_output = gather_output
        self.world_size = n
        self.rank = r
        self.weight.mp_shard = n > 1
        if self.bias is not None:
            self.bias.mp_shard = n > 1

    def forward(self, x):
        if self.world_size == 1:
            return super().forward(x)
        out = F.linear(copy_to_mp(x), self.weight, self.bias)
        return gather_mp(out) if self.gather_output else out


class RowParallelLinear(Linear):
    """Linear over this rank's input rows: partial products all-reduced,
    the bias added once after."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None,
                 device=None, dtype=None):
        n, r = mp_degree()
        super().__init__(_per_rank(n, "in_features", in_features),
                         out_features, has_bias=has_bias, device=device,
                         dtype=dtype)
        self.input_is_parallel = input_is_parallel
        self.world_size = n
        self.rank = r
        self.weight.mp_shard = n > 1

    def forward(self, x):
        if self.world_size == 1:
            return super().forward(x)
        if not self.input_is_parallel:
            x = split_mp(x)
        out = allreduce_mp(F.linear(x, self.weight))
        if self.bias is None:
            return out
        out, bias = amp.cast_inputs_for("add", (out, self.bias))
        return out + bias


def parallel_cross_entropy(logits, label, ignore_index=-100, axis="mp"):
    """Per-position softmax CE of vocab-sharded `logits` [..., V/mp]
    (this rank's vocab range) against int `label` [...] (the reference's
    `_vocab_parallel_ce`, gpt_pipeline.py:191): the LSE reduced across
    the group, the target logit picked where it is local. Positions
    equal to `ignore_index` give 0. float32."""
    _, pos, _ = mp_world(axis)
    lf = logits.float()
    v_loc = lf.shape[-1]
    m = all_reduce_mp_raw(lf.detach().amax(-1), op="max", axis=axis)
    ssum = allreduce_mp(torch.exp(lf - m[..., None]).sum(-1), axis)
    lse = m + torch.log(ssum)
    lbl = label.long()
    li = lbl - pos * v_loc
    hit = (li >= 0) & (li < v_loc)
    picked = torch.where(
        hit, lf.gather(-1, li.clamp(0, v_loc - 1)[..., None])[..., 0], 0.0)
    loss = lse - allreduce_mp(picked, axis)
    return torch.where(lbl == ignore_index, 0.0, loss)


class ParallelCrossEntropy(Layer):
    """Vocab-parallel softmax CE (reduction "none"); at mp 1 the plain
    per-position CE over the whole vocab."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, input, label):
        if len(mp_world()[0]) == 1:
            return cross_entropy(input, label, reduction="none",
                                 ignore_index=self.ignore_index)
        if label.ndim == input.ndim:
            label = label.squeeze(-1)
        return parallel_cross_entropy(input, label, self.ignore_index)


@torch.no_grad()
def load_full(layer, weight, bias=None):
    """Copy this rank's slice of a WHOLE logical `weight` (and `bias`)
    into a parallel layer (numpy arrays or tensors): a column layer's
    columns, a row layer's rows (the whole bias), an embedding's vocab
    rows. Returns the layer."""
    w = torch.as_tensor(weight)
    n = getattr(layer, "world_size", 1)
    if isinstance(layer, VocabParallelEmbedding):
        c = w.shape[0] // n
        w = w[layer.vocab_start:layer.vocab_start + c]
    elif isinstance(layer, ColumnParallelLinear):
        c = w.shape[1] // n
        w = w[:, layer.rank * c:(layer.rank + 1) * c]
        if bias is not None:
            bias = torch.as_tensor(bias)[layer.rank * c:(layer.rank + 1) * c]
    elif isinstance(layer, RowParallelLinear):
        c = w.shape[0] // n
        w = w[layer.rank * c:(layer.rank + 1) * c]
    layer.weight.copy_(w.to(layer.weight))
    if bias is not None and layer.bias is not None:
        layer.bias.copy_(torch.as_tensor(bias).to(layer.bias))
    return layer
