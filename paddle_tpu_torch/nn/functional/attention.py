"""Attention functional (counterpart of
paddle_tpu/nn/functional/attention.py).

`paged_attention` is the serving path: on a CUDA tensor it always runs
the hand-written ragged paged attention kernel
(ops/cuda_kernels/paged_attention.py), on a CPU tensor its plain
PyTorch version. `scaled_dot_product_attention` (the training path)
raises on CUDA tensors until the flash-attention kernels are ported.
"""
import math

import torch

from ...ops.cuda_kernels import paged_attention as _pa

__all__ = ["scaled_dot_product_attention", "dense_attention_bshd",
           "paged_attention"]


def dense_attention_bshd(q, k, v, is_causal=False, attn_mask=None):
    """Plain softmax attention on [batch, seq, heads, head_dim] — the
    port of the JAX package's jnp formulation, op for op."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    scores = torch.einsum("bhqd,bhkd->bhqk", qt, kt) * scale
    if is_causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        causal = torch.ones((sq, sk), dtype=torch.bool,
                            device=q.device).tril(sk - sq)
        scores = scores.masked_fill(~causal, float("-inf"))
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            scores = scores.masked_fill(~attn_mask, float("-inf"))
        else:
            scores = scores + attn_mask
    w = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    w = w / w.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", w.to(vt.dtype), vt)
    return out.transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 is_causal=False):
    """Inputs [batch, seq, heads, head_dim] (paddle convention). The
    plain version runs on CPU tensors; on the card this is the flash
    attention kernels' job (ROADMAP A8, kernels K3-K5), not ported yet —
    so a CUDA tensor raises instead of quietly running plain attention
    on the card."""
    if query.is_cuda:
        raise NotImplementedError(
            "scaled_dot_product_attention on CUDA needs the flash-attention "
            "kernels (ROADMAP A8: the training slice, kernels K3-K5), not "
            "ported yet")
    return dense_attention_bshd(query, key, value, is_causal=is_causal,
                                attn_mask=attn_mask)


def paged_attention(query, k_pool, v_pool, page_tables, slot_ids, kv_lens,
                    k_scales=None, v_scales=None, frontier_offset=None):
    """Ragged paged attention over a paged KV-cache pool: one query per
    flat scheduled token, against its slot's pages.

    query         [T, heads, head_dim]
    k_pool/v_pool [num_pages, page_size, heads, head_dim]; page 0 is
                  the engine's trash page
    page_tables   [num_slots, pages_per_seq] int32 — entries past a
                  token's kv length may hold stale ids and are not read
    slot_ids      [T] int32 owning slot per token
    kv_lens       [T] int32 valid kv length per token (position + 1);
                  0 marks a padding token → exact zero output
    frontier_offset  optional int added to every NONZERO kv_lens row
    k_scales/v_scales  quantized pools — not ported yet (ROADMAP A4)."""
    return _pa.ragged_paged_attention(
        query, k_pool, v_pool, page_tables, slot_ids, kv_lens,
        k_scales=k_scales, v_scales=v_scales,
        frontier_offset=frontier_offset)
