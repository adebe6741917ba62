"""Tensor-parallel layers, single-rank forms (counterpart of
paddle_tpu/distributed/fleet/meta_parallel/mp_layers.py).

On one GPU the mp axis has size 1, so each layer is its plain
counterpart with the JAX package's constructor surface and parameter
layout. Real tensor parallelism over NCCL is ROADMAP A11.
"""
from torch import nn

from ....nn.functional import cross_entropy
from ....nn.layer.common import Embedding, Linear

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "split_fused_qkv"]


def split_fused_qkv(qkv, batch, seq, num_heads, head_dim):
    """[b, s, 3·d] fused qkv → (q, k, v), each [b, s, nh, hd]. The fused
    layout is [b, s, 3, nh, hd] — q, k, v outermost, then heads — as in
    the JAX package; a split in another order keeps every shape and
    gives wrong attention."""
    qkv = qkv.reshape(batch, seq, 3, num_heads, head_dim)
    return qkv.unbind(2)


class VocabParallelEmbedding(Embedding):
    pass


class ColumnParallelLinear(Linear):
    def __init__(self, in_features, out_features, has_bias=None,
                 gather_output=True, device=None, dtype=None):
        super().__init__(in_features, out_features,
                         has_bias=has_bias is None or bool(has_bias),
                         device=device, dtype=dtype)
        self.gather_output = gather_output


class RowParallelLinear(Linear):
    def __init__(self, in_features, out_features, has_bias=True,
                 input_is_parallel=False, device=None, dtype=None):
        super().__init__(in_features, out_features, has_bias=has_bias,
                         device=device, dtype=dtype)
        self.input_is_parallel = input_is_parallel


class ParallelCrossEntropy(nn.Module):
    """Vocab-parallel softmax CE; on one rank the plain per-position CE
    (reduction "none") over the whole vocab."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, input, label):
        return cross_entropy(input, label, reduction="none",
                             ignore_index=self.ignore_index)
