"""Multi-head attention (counterpart of the MultiHeadAttention of
paddle_tpu/nn/layer/transformer.py; the encoder / decoder stacks are
ROADMAP A12's).

The q / k / v / out projections are paddle `Linear`s under the
reference's names, so a reference state dict loads key for key and the
auto-parallel planner sees the same units. A boolean `attn_mask` (True
keeps) becomes the reference's additive 0 / -1e9 mask in q's dtype.
"""
import torch
from torch import nn

from .. import functional as F
from .common import Linear

__all__ = ["MultiHeadAttention"]


def _convert_attention_mask(attn_mask, dtype):
    if attn_mask is None:
        return None
    attn_mask = torch.as_tensor(attn_mask)
    if attn_mask.dtype == torch.bool:
        return torch.where(attn_mask, 0.0, -1e9).to(dtype)
    return attn_mask


class MultiHeadAttention(nn.Module):
    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, device=None, dtype=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim if kdim is not None else embed_dim
        self.vdim = vdim if vdim is not None else embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.head_dim = embed_dim // num_heads
        assert self.head_dim * num_heads == embed_dim
        kw = dict(device=device, dtype=dtype)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(self.kdim, embed_dim, **kw)
        self.v_proj = Linear(self.vdim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def _split_heads(self, x, heads=None):
        return x.reshape(x.shape[0], x.shape[1], heads or self.num_heads,
                         self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        if cache is not None:
            raise NotImplementedError(
                "MultiHeadAttention caches: ROADMAP A12 (nn/layer/"
                "transformer)")
        key = query if key is None else key
        value = key if value is None else value
        q = self._split_heads(self.q_proj(query))
        k = self._split_heads(self.k_proj(key))
        v = self._split_heads(self.v_proj(value))
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=_convert_attention_mask(attn_mask, q.dtype),
            dropout_p=self.dropout, training=self.training)
        return self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                         self.embed_dim))
