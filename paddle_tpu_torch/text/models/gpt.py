"""GPT — decoder-only causal language model (counterpart of
paddle_tpu/text/models/gpt.py).

Same configurations, parameter names and layouts as the JAX package, so
a JAX `state_dict()` loads key for key (`paddle_tpu_torch.convert`).

Training: `forward` (flash attention through
`F.scaled_dot_product_attention`, optional per-layer recompute) with
`GPTPretrainingCriterion`, or `fused_head_loss`, which fuses the vocab
head with the softmax CE. Serving: `_paged_decode_core` — flat ragged
tokens through every layer, the step's K/V written into the paged pools,
ragged paged attention against each token's own prefix, and the vocab
head on the gathered sampling-frontier rows only.
"""
import torch
from torch import nn

from ... import nn as pnn
from ...core.dtype import resolve_dtype
from ...core.place import resolve_device
from ...distributed.fleet.meta_parallel.mp_layers import (
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding, split_fused_qkv)
from ...distributed.fleet.recompute import checkpoint_policy, recompute
from ...nn import functional as F

__all__ = ["GPTConfig", "GPTDecoderLayer", "GPTModel", "GPTForCausalLM",
           "GPTPretrainingCriterion", "gpt_tiny", "gpt_small", "gpt_medium",
           "gpt_1p3b"]


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, ffn_size=None, max_seq_len=1024,
                 dropout=0.0, tie_embeddings=True, recompute=False):
        checkpoint_policy(recompute)    # named jax policies raise
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ffn_size = ffn_size or 4 * hidden_size
        self.max_seq_len = max_seq_len
        self.dropout = dropout
        self.tie_embeddings = tie_embeddings
        # per-layer activation recompute: False | True (keep nothing)
        self.recompute = recompute


def gpt_tiny(**kw):
    return GPTConfig(vocab_size=2048, hidden_size=128, num_layers=2,
                     num_heads=4, max_seq_len=256, **kw)


def gpt_small(**kw):
    return GPTConfig(vocab_size=50304, hidden_size=768, num_layers=12,
                     num_heads=12, max_seq_len=1024, **kw)


def gpt_medium(**kw):
    return GPTConfig(vocab_size=50304, hidden_size=1024, num_layers=24,
                     num_heads=16, max_seq_len=1024, **kw)


def gpt_1p3b(**kw):
    return GPTConfig(vocab_size=50304, hidden_size=2048, num_layers=24,
                     num_heads=32, max_seq_len=2048, **kw)


class GPTDecoderLayer(nn.Module):
    """Pre-LN block: LN → fused-qkv attention → residual, LN → MLP →
    residual."""

    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        d = config.hidden_size
        self.nh = config.num_heads
        self.hd = d // config.num_heads
        self.ln1 = pnn.LayerNorm(d, **kw)
        self.qkv = ColumnParallelLinear(d, 3 * d, gather_output=False, **kw)
        self.proj = RowParallelLinear(d, d, input_is_parallel=True, **kw)
        self.ln2 = pnn.LayerNorm(d, **kw)
        self.fc1 = ColumnParallelLinear(d, config.ffn_size,
                                        gather_output=False, **kw)
        self.fc2 = RowParallelLinear(config.ffn_size, d,
                                     input_is_parallel=True, **kw)
        self.dropout = pnn.Dropout(config.dropout)

    def forward(self, x):
        b, s = x.shape[0], x.shape[1]
        q, k, v = split_fused_qkv(self.qkv(self.ln1(x)), b, s, self.nh,
                                  self.hd)
        attn = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        x = x + self.dropout(self.proj(attn.reshape(b, s, self.nh * self.hd)))
        return x + self.dropout(self.fc2(F.gelu(self.fc1(self.ln2(x)))))


class GPTModel(nn.Module):
    """Token + position embeddings, N decoder layers, final LN."""

    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.config = config
        self.wte = VocabParallelEmbedding(config.vocab_size,
                                          config.hidden_size, **kw)
        self.wpe = pnn.Embedding(config.max_seq_len, config.hidden_size,
                                 **kw)
        self.drop = pnn.Dropout(config.dropout)
        self.layers = nn.ModuleList(
            [GPTDecoderLayer(config, **kw) for _ in range(config.num_layers)])
        self.ln_f = pnn.LayerNorm(config.hidden_size, **kw)

    def forward(self, input_ids):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)
        x = self.drop(self.wte(input_ids) + self.wpe(pos))
        for layer in self.layers:
            x = recompute(layer, x) if self.config.recompute else layer(x)
        return self.ln_f(x)


def _paged_cache_write(k_pool, v_pool, k_new, v_new, write_idx):
    """Scatter per-token k/v rows [T, H, D] into the pools [N, P, H, D]
    at flat rows `write_idx` (page_id * page_size + offset). IN PLACE:
    the JAX package returns new pools and donates the old ones to the
    compiled step; here the pool tensors are updated where they lie.
    Page 0 is the trash page: padding tokens all write flat row 0, where
    collisions are harmless — trash rows are never attended."""
    idx = write_idx.long()
    k_pool.view(-1, *k_pool.shape[2:])[idx] = k_new.to(k_pool.dtype)
    v_pool.view(-1, *v_pool.shape[2:])[idx] = v_new.to(v_pool.dtype)


def _layer_forward_paged(layer, x, cache_k, cache_v, write_idx, page_tables,
                         slot_ids, kv_lens, frontier_offset=None):
    """Paged-cache decoder block over the flat token layout [1, T, d]:
    write the step's k/v into the pools (in place), then ragged paged
    attention against each token's own prefix."""
    T = x.shape[1]
    q, k, v = split_fused_qkv(layer.qkv(layer.ln1(x)), 1, T, layer.nh,
                              layer.hd)
    q = q.reshape(T, layer.nh, layer.hd).contiguous()
    _paged_cache_write(cache_k, cache_v, k.reshape(T, layer.nh, layer.hd),
                       v.reshape(T, layer.nh, layer.hd), write_idx)
    attn = F.paged_attention(q, cache_k, cache_v, page_tables, slot_ids,
                             kv_lens, frontier_offset=frontier_offset)
    x = x + layer.proj(attn.reshape(1, T, layer.nh * layer.hd))
    return x + layer.fc2(F.gelu(layer.fc1(layer.ln2(x))))


class GPTForCausalLM(nn.Module):
    """LM head tied to the embedding by default (`tie_embeddings=False`:
    a `lm_head` [hidden, vocab] without bias). `device` defaults to CUDA
    (raises when no GPU is present; `device="cpu"` runs the plain
    versions). Weights are drawn from `seed` through an explicit
    `torch.Generator`: N(0, 0.02) for matrices, ones / zeros for
    LayerNorm, zero biases."""

    def __init__(self, config, device=None, dtype="float32", seed=0):
        super().__init__()
        device = resolve_device(device)
        dtype = resolve_dtype(dtype)
        self.config = config
        self.gpt = GPTModel(config, device=device, dtype=dtype)
        self.lm_head = None if config.tie_embeddings else ColumnParallelLinear(
            config.hidden_size, config.vocab_size, has_bias=False,
            gather_output=False, device=device, dtype=dtype)
        self.reset_parameters(seed)

    @property
    def device(self):
        return self.gpt.wte.weight.device

    @property
    def dtype(self):
        return self.gpt.wte.weight.dtype

    @torch.no_grad()
    def reset_parameters(self, seed=0):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        for name, p in self.named_parameters():
            if ".ln" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=gen)

    def _logits_from_hidden(self, x):
        if self.lm_head is not None:
            return self.lm_head(x)
        # tied head: x @ wte.weight.T (wte.weight is [vocab, d])
        return F.linear(x, self.gpt.wte.weight.t())

    def forward(self, input_ids):
        return self._logits_from_hidden(self.gpt(input_ids))

    def fused_head_loss(self, input_ids, labels=None, block_size=4096):
        """Shifted next-token loss with the head projection and softmax
        CE fused (`F.fused_linear_cross_entropy`): the [b, s, vocab]
        logits are never kept. Sum over the total count of positions
        (ignored ones add 0), so loss and gradient scale equal
        `GPTPretrainingCriterion`'s mean."""
        if labels is None:
            labels = input_ids
        x = self.gpt(input_ids)
        shift_x = x[:, :-1]
        shift_labels = labels[:, 1:]
        total = shift_labels.shape[0] * shift_labels.shape[1]
        if self.lm_head is not None:
            s = F.fused_linear_cross_entropy(
                shift_x, self.lm_head.weight, shift_labels,
                reduction="sum", block_size=block_size)
        else:
            s = F.fused_linear_cross_entropy(
                shift_x, self.gpt.wte.weight, shift_labels,
                transpose_weight=True, reduction="sum",
                block_size=block_size)
        return s / float(total)

    def _paged_decode_core(self, tok, pos_ids, slot_ids, write_idx,
                           page_tables, kv_lens, sample_idx, kv,
                           frontier_offset=None):
        """One ragged engine step over flat tokens: tok / pos_ids /
        slot_ids / write_idx / kv_lens [T], page_tables [S, MP],
        sample_idx [S] (the flat row holding each slot's sampling
        frontier; stale slots point anywhere), kv = 2·num_layers pools,
        updated IN PLACE. Returns logits [1, S, vocab]: the vocab head
        runs only on the S gathered frontier rows, never on prefill
        tokens."""
        model = self.gpt
        x = model.wte(tok.unsqueeze(0)) + model.wpe(pos_ids)
        for i, layer in enumerate(model.layers):
            x = _layer_forward_paged(layer, x, kv[2 * i], kv[2 * i + 1],
                                     write_idx, page_tables, slot_ids,
                                     kv_lens, frontier_offset)
        x = model.ln_f(x)
        x = x.index_select(1, sample_idx.long())   # [1, S, d] frontiers
        return self._logits_from_hidden(x)


class GPTPretrainingCriterion(nn.Module):
    """Shifted next-token cross entropy, mean over every position."""

    def __init__(self):
        super().__init__()
        self.ce = ParallelCrossEntropy()

    def forward(self, logits, labels):
        loss = self.ce(logits[:, :-1], labels[:, 1:])
        return loss.mean()
