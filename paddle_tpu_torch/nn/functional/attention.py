"""Attention functional (counterpart of
paddle_tpu/nn/functional/attention.py).

`scaled_dot_product_attention` follows the reference's dispatch: with no
`attn_mask`, no attention dropout and seq_q == seq_k it runs flash
attention (ops/cuda_kernels/flash_attention.py) — on a CUDA tensor always
the hand-written kernels K3 (forward) and K4 + K5 (backward), on a CPU
tensor their plain versions. A mask, attention dropout or cross-length
attention takes `dense_attention_bshd`, the reference's own non-kernel
path. `paged_attention` is the serving path: the ragged paged attention
kernels (K1, or K2 on the speculative verify layout) on a CUDA tensor,
their plain version on a CPU tensor.
"""
import math

import torch

from ... import amp
from ...core import rng
from ...ops.cuda_kernels import flash_attention as _fa
from ...ops.cuda_kernels import paged_attention as _pa

__all__ = ["scaled_dot_product_attention", "dense_attention_bshd",
           "paged_attention"]


def dense_attention_bshd(q, k, v, is_causal=False, attn_mask=None,
                         generator=None, dropout_p=0.0):
    """Plain softmax attention on [batch, seq, heads, head_dim] — the
    port of the JAX package's jnp formulation, op for op. Attention
    dropout (`dropout_p` > 0 with a `generator`) drops softmax weights
    with the keep mask drawn from that generator."""
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
    if generator is not None and dropout_p > 0.0:
        keep = torch.rand(w.shape, generator=generator,
                          device=w.device) >= dropout_p
        w = torch.where(keep, w / (1.0 - dropout_p), 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", w.to(vt.dtype), vt)
    return out.transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, kv_lens=None, name=None):
    """Inputs [batch, seq, heads, head_dim] (paddle convention).

    kv_lens: optional [batch] int per-example valid key length (prefix
    key-padding mask); it rides the flash kernels. Mutually exclusive
    with attn_mask."""
    if kv_lens is not None and attn_mask is not None:
        raise ValueError("pass either attn_mask or kv_lens, not both")
    if (attn_mask is None and dropout_p == 0.0
            and query.shape[1] == key.shape[1]):
        q, k, v = amp.cast_inputs_for("flash_attention",
                                      (query, key, value))
        return _fa.flash_attention_bshd(q, k, v, causal=is_causal,
                                        kv_lens=kv_lens)

    gen = None
    if dropout_p > 0.0 and training:
        gen = rng.current_generator() or rng.next_generator(query.device)
    q, k, v, mask = amp.cast_inputs_for(
        "scaled_dot_product_attention", (query, key, value, attn_mask))
    if kv_lens is None:
        return dense_attention_bshd(q, k, v, is_causal=is_causal,
                                    attn_mask=mask, generator=gen,
                                    dropout_p=dropout_p)
    lens = torch.as_tensor(kv_lens, device=q.device).long()
    # zero-length rows: mask against max(len, 1) (a fully masked softmax
    # row is NaN), then zero those rows — the flash kernels' safe_l zeros
    keep = (torch.arange(k.shape[1], device=q.device)[None, :]
            < torch.clamp(lens, min=1)[:, None])[:, None, None, :]
    out = dense_attention_bshd(q, k, v, is_causal=is_causal, attn_mask=keep,
                               generator=gen, dropout_p=dropout_p)
    return torch.where((lens > 0)[:, None, None, None], out, 0.0)


def paged_attention(query, k_pool, v_pool, page_tables, slot_ids, kv_lens,
                    k_scales=None, v_scales=None, frontier_offset=None,
                    max_tokens_per_slot=None):
    """Ragged paged attention over a paged KV-cache pool: one query per
    flat scheduled token, against its slot's pages.

    query         [T, heads, head_dim]
    k_pool/v_pool [num_pages, page_size, heads, head_dim] float, or int8
                  codes (packed int4: [..., head_dim / 2]); page 0 is
                  the engine's trash page
    page_tables   [num_slots, pages_per_seq] int32 — entries past a
                  token's kv length may hold stale ids and are not read
    slot_ids      [T] int32 owning slot per token
    kv_lens       [T] int32 valid kv length per token (position + 1);
                  0 marks a padding token → exact zero output
    k_scales/v_scales  [num_pages, page_size, heads] fp32 per-row scales
                  of int8 / int4 pools (dequantized on gather)
    frontier_offset  optional int added to every NONZERO kv_lens row
    max_tokens_per_slot  optional int, the caller's guarantee that no
                  slot owns more than this many of the T tokens. When T
                  is a multiple of it the rows are taken as slot-major
                  blocks of that size (the speculative verify layout) and
                  the query-blocked kernel K2 runs."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both k_scales and v_scales or neither")
    qps = (max_tokens_per_slot
           if max_tokens_per_slot is not None
           and query.shape[0] % max_tokens_per_slot == 0 else None)
    return _pa.ragged_paged_attention(
        query, k_pool, v_pool, page_tables, slot_ids, kv_lens,
        k_scales=k_scales, v_scales=v_scales,
        frontier_offset=frontier_offset, q_per_slot=qps)
