"""GPT — decoder-only causal language model (counterpart of
paddle_tpu/text/models/gpt.py).

Same configurations, parameter names and layouts as the JAX package, so
a JAX `state_dict()` loads key for key (`paddle_tpu_torch.convert`).

Training: `forward` (flash attention through
`F.scaled_dot_product_attention`, optional per-layer recompute) with
`GPTPretrainingCriterion`, or `fused_head_loss`, which fuses the vocab
head with the softmax CE. Serving: `_paged_decode_core` — flat ragged
tokens through every layer, the step's K/V written into the paged pools
(float, or int8 / packed int4 with per-row scale planes), ragged paged
attention against each token's own prefix, and the vocab head on the
gathered sampling-frontier rows only; `_paged_decode_fused` — k decode
ticks in one call with the pick, EOS and budget masking inside (the
engine captures it as one CUDA graph); `_paged_verify_fused` — the
speculative verify step over k+1 positions per slot, with exact-match
acceptance. `sample_tokens` is the reference's keyed greedy /
temperature / top-p sampler, on jax's threefry bits (`core.prng`), with
the structured-decoding grammar mask (`grammar_allowed`) applied before
the pick in both windows when the engine passes its arena tables.
"""
import torch
from torch import nn

from ... import nn as pnn
from ...core import prng
from ...core.dtype import resolve_dtype
from ...core.place import resolve_device
from ...distributed.fleet.meta_parallel.mp_layers import (
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding, split_fused_qkv)
from ...distributed.fleet.recompute import checkpoint_policy, recompute
from ...nn import functional as F
from ...quantization import runtime as _qrt

__all__ = ["GPTConfig", "GPTDecoderLayer", "GPTModel", "GPTForCausalLM",
           "GPTPretrainingCriterion", "gpt_tiny", "gpt_small", "gpt_medium",
           "gpt_1p3b", "grammar_allowed", "sample_tokens"]


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


def _paged_cache_write_quant(k_pool, v_pool, k_scales, v_scales, k_new,
                             v_new, write_idx):
    """Int8 / int4 variant of `_paged_cache_write`, IN PLACE: each new
    k/v row is quantized once with its own per-(token, head) scale
    (`quantize_kv_rows` / `quantize_kv_rows_int4`), the codes are
    scattered into the pools and the scales into the page-shaped scale
    planes [N, P, H] at the same flat rows, so later writes to a page
    never touch earlier rows. The pool's last dim picks the codec: head_dim
    → int8, head_dim / 2 → packed int4."""
    packed4 = k_pool.shape[-1] * 2 == k_new.shape[-1]
    quant_rows = (_qrt.quantize_kv_rows_int4 if packed4
                  else _qrt.quantize_kv_rows)
    idx = write_idx.long()
    for pool, scales, new in ((k_pool, k_scales, k_new),
                              (v_pool, v_scales, v_new)):
        codes, scale = quant_rows(new)
        pool.view(-1, *pool.shape[2:])[idx] = codes
        scales.view(-1, scales.shape[2])[idx] = scale


def _layer_forward_paged(layer, x, cache_k, cache_v, write_idx, page_tables,
                         slot_ids, kv_lens, k_scales=None, v_scales=None,
                         frontier_offset=None, max_q_per_slot=None):
    """Paged-cache decoder block over the flat token layout [1, T, d]:
    write the step's k/v into the pools (in place; quantized with their
    scale planes when `k_scales` / `v_scales` are given), then ragged
    paged attention against each token's own prefix. `max_q_per_slot` is
    the speculative verify's hint: at most that many tokens per slot,
    slot-major (the query-blocked kernel K2)."""
    T = x.shape[1]
    q, k, v = split_fused_qkv(layer.qkv(layer.ln1(x)), 1, T, layer.nh,
                              layer.hd)
    q = q.reshape(T, layer.nh, layer.hd).contiguous()
    k = k.reshape(T, layer.nh, layer.hd)
    v = v.reshape(T, layer.nh, layer.hd)
    if k_scales is None:
        _paged_cache_write(cache_k, cache_v, k, v, write_idx)
    else:
        _paged_cache_write_quant(cache_k, cache_v, k_scales, v_scales, k, v,
                                 write_idx)
    attn = F.paged_attention(q, cache_k, cache_v, page_tables, slot_ids,
                             kv_lens, k_scales=k_scales, v_scales=v_scales,
                             frontier_offset=frontier_offset,
                             max_tokens_per_slot=max_q_per_slot)
    x = x + layer.proj(attn.reshape(1, T, layer.nh * layer.hd))
    return x + layer.fc2(F.gelu(layer.fc1(layer.ln2(x))))


def _sampling_scores(logits, temps, top_ps, streams, positions, key):
    """The scores whose argmax is a sampled row's pick (the reference's
    `drawn` branch, gpt.py:358-374): logits [R, vocab] f32 scaled by
    1 / max(temps, 1e-6); top-p keeps the smallest prefix of the
    descending list whose exclusive cumulative mass is < top_p (always
    the top-1), the rest masked to -1e30; plus the Gumbel noise of the
    row's key fold_in(fold_in(key, stream), position) (`core.prng`).
    temps / top_ps [R] f32, streams / positions [R] int, key [2] int64:
    tensors on logits' device."""
    scaled = logits / torch.clamp_min(temps, 1e-6)[:, None]
    srt = torch.sort(scaled, dim=-1, descending=True).values
    # jax.nn.softmax: exp(x - max) / sum
    e = torch.exp(srt - srt[:, :1])
    probs = e / e.sum(dim=-1, keepdim=True)
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_ps[:, None]
    thresh = torch.where(keep, srt, float("inf")).amin(dim=-1)
    masked = torch.where(scaled >= thresh[:, None], scaled, -1e30)
    keys = prng.fold_in(prng.fold_in(key, streams), positions)
    return prng.gumbel(keys, logits.shape[-1]) + masked


def sample_tokens(logits, temps=None, top_ps=None, streams=None,
                  positions=None, key=None, allowed=None):
    """The reference's `sample_tokens` (gpt.py:331): logits [R, vocab] f32
    → int32 [R]. Rows with temps <= 0 take the argmax (the first maximal
    index, in both frameworks); rows with temps > 0 draw from the
    temperature-scaled, top-p-truncated distribution with the per-row key
    fold_in(fold_in(key, stream), position), so a draw depends only on
    (engine seed, request stream, token position): not on the decode
    window, the batch or a preemption replay.

    allowed (optional) [R, vocab] bool — the structured-decoding grammar
    mask (`grammar_allowed`): False entries become -1e30 BEFORE both the
    greedy argmax and the top-p truncation, so a constrained row's pick is
    always grammar-legal. An all-True row is a value-level no-op: it picks
    bit-identically to `allowed=None`.

    The reference picks the branch on the device (`lax.cond` on
    any(temps > 0)); here the caller picks it on the host, because a CUDA
    graph cannot branch on device data: `key` None runs the greedy branch
    only, a key the draw (greedy rows still take the argmax). temps
    without a key may only hold greedy rows; that is checked when temps
    lies on the CPU (no device sync is made)."""
    if allowed is not None:
        logits = torch.where(allowed, logits, -1e30)
    greedy = logits.argmax(dim=-1).to(torch.int32)
    if key is None:
        if (temps is not None and temps.device.type == "cpu"
                and bool((temps > 0).any())):
            raise ValueError(
                "a row with temperature > 0 draws from the engine's key: "
                "pass top_ps, streams, positions and key")
        return greedy
    pick = _sampling_scores(logits, temps, top_ps, streams, positions,
                            key).argmax(dim=-1).to(torch.int32)
    return torch.where(temps > 0, pick, greedy)


def grammar_allowed(gmask, gstate, vocab):
    """Expand grammar-arena bitsets to a boolean logits mask (the
    reference's gpt.py:393): gmask [G, ceil(vocab/32)] int32 (the arena's
    uint32 words, same bits), gstate [R] int (arena-absolute DFA state per
    row) → [R, vocab] bool for `sample_tokens(allowed=)`. The shift is
    int32 and arithmetic: a set bit 31 fills the upper bits with ones,
    never bit 0, so `& 1` reads each bit exactly."""
    words = gmask[gstate.long()]                           # [R, W]
    v = torch.arange(int(vocab), dtype=torch.int32, device=gmask.device)
    return ((words[:, (v // 32).long()] >> (v % 32)) & 1).bool()


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
                           kv_scales=None, frontier_offset=None,
                           max_q_per_slot=None):
        """One ragged engine step over flat tokens: tok / pos_ids /
        slot_ids / write_idx / kv_lens [T], page_tables [S, MP],
        sample_idx [R] (the flat rows whose logits are wanted — each
        slot's sampling frontier; stale slots point anywhere), kv =
        2·num_layers pools, updated IN PLACE; kv_scales the 2·num_layers
        scale planes of int8 / int4 pools (also in place).
        `max_q_per_slot`: the verify step's hint (see
        `_layer_forward_paged`). Returns (logits [1, R, vocab], *pools,
        *scales) as the reference does, the pools being the same tensors
        it was given: the vocab head runs only on the gathered rows,
        never on prefill tokens."""
        model = self.gpt
        x = model.wte(tok.unsqueeze(0)) + model.wpe(pos_ids)
        for i, layer in enumerate(model.layers):
            x = _layer_forward_paged(
                layer, x, kv[2 * i], kv[2 * i + 1], write_idx, page_tables,
                slot_ids, kv_lens,
                k_scales=None if kv_scales is None else kv_scales[2 * i],
                v_scales=None if kv_scales is None else kv_scales[2 * i + 1],
                frontier_offset=frontier_offset,
                max_q_per_slot=max_q_per_slot)
        x = model.ln_f(x)
        x = x.index_select(1, sample_idx.long())   # [1, R, d] frontiers
        return (self._logits_from_hidden(x), *kv, *(kv_scales or ()))

    def _paged_decode_fused(self, k, page_size, tok0, pos0, rem, fin0,
                            eos_ids, temps, top_ps, streams, page_tables, kv,
                            kv_scales=None, key=None, logits_out=None,
                            lag=None, frontier=None, gstate0=None,
                            gtrans=None, gmask=None):
        """k decode ticks in one call (the reference's gpt.py:523, whose
        `lax.scan` becomes k iterations unrolled here, so the engine can
        capture the whole window as one CUDA graph): per iteration, write
        the frontier token's KV, ragged paged attention over each slot's
        own prefix (K1 on the card, `frontier_offset=i` a Python int baked
        into the launch), the vocab head on the S frontier rows, and the
        keyed pick (`sample_tokens` at position pos + 1), with EOS and
        budget masking: a row that picks its eos or spends `rem` flips
        finished, and from the next iteration on writes the trash row at
        kv_len 0 and emits -1. No host sync anywhere in the window.

        tok0 / pos0 / rem / streams [S] int32 (frontier token, its write
        position, tokens the row may still emit, sampling stream), fin0
        [S] bool (True = empty slot), eos_ids [S] int32 (-1 = none), temps
        / top_ps [S] f32, page_tables [S, MP]: tensors on the pools'
        device; the engine reserves every live iteration's pages before
        the call. k is a Python int. key: the engine's [2] int64 key, or
        None when every row is greedy (the host's choice, see
        `sample_tokens`). kv / kv_scales are updated IN PLACE. logits_out:
        an optional list that receives each iteration's f32 frontier
        logits [S, vocab], before any grammar mask.

        lag / frontier (the draft's propose mode, the reference's gpt.py:587
        and :628-632; both [S] int32 device tensors, or both None): a row
        with lag 1 starts one position early, at pos0 - 1 with `tok0` the
        token there, so the draft KV row the previous window left
        unwritten is written inside this window; its iteration-0 pick is
        forced to `frontier` (the token at pos0, already known), so the
        later proposals condition on the true sequence. Being tensors,
        one captured window serves any mix of lag rows.

        gstate0 / gtrans / gmask (structured decoding, all three or none):
        gstate0 [S] int32 arena-absolute grammar DFA states, gtrans [G,
        vocab] int32 and gmask [G, ceil(vocab/32)] int32 the engine's
        arena tables (`inference/structured/arena`). The state rides the
        window like the token does: each iteration masks the logits
        through `grammar_allowed` before the pick, then advances
        `gs = gtrans[gs, nxt]` on live rows. Arena row 0 is the identity,
        so unconstrained rows pick bit-identically. The reference's
        `lax.cond(any(gstate0 > 0))` is the host's choice here: it passes
        the tables only when a row has a grammar, and the window without
        them holds no mask op.
        Returns (emits [k, S] int32, kv, kv_scales)."""
        S = tok0.shape[0]
        dev = tok0.device
        i32 = torch.int32
        sl = torch.arange(S, dtype=i32, device=dev)
        pt = page_tables.to(i32)
        zero = torch.zeros((), dtype=i32, device=dev)
        start = pos0.to(i32) if lag is None else pos0.to(i32) - lag
        klen0 = start + 1
        tok, fin = tok0.to(i32), fin0
        gs = None if gtrans is None else gstate0.to(i32)
        emits = []
        for i in range(int(k)):
            live = ~fin
            tok_in = torch.where(live, tok, zero)
            pos_in = torch.where(live, start + i, zero)
            klen = torch.where(live, klen0, zero)   # + i rides the offset
            page = pt[sl.long(), (pos_in // page_size).long()]
            widx = torch.where(live, page * page_size + pos_in % page_size,
                               zero)
            logits, *_ = self._paged_decode_core(
                tok_in, pos_in, sl, widx, pt, klen, sl, kv,
                kv_scales=kv_scales, frontier_offset=i)
            lv = logits[0].float()                           # [S, V]
            if logits_out is not None:
                logits_out.append(lv)
            allowed = (None if gs is None
                       else grammar_allowed(gmask, gs, lv.shape[1]))
            nxt = sample_tokens(lv, temps, top_ps, streams, pos_in + 1, key,
                                allowed=allowed)
            if lag is not None and i == 0:
                # a lag row's iteration-0 output is the known frontier
                nxt = torch.where(lag > 0, frontier.to(i32), nxt)
            emits.append(torch.where(live, nxt, torch.full_like(nxt, -1)))
            fin = (fin | (live & (eos_ids >= 0) & (nxt == eos_ids))
                   | (live & (i + 1 >= rem)))
            tok = torch.where(live, nxt, tok)
            if gs is not None:
                gs = torch.where(live, gtrans[gs.long(), nxt.long()], gs)
        return torch.stack(emits), kv, kv_scales

    def _paged_verify_fused(self, k, page_size, tok0, pos0, drafts, width,
                            rem, fin0, eos_ids, temps, page_tables, kv,
                            kv_scales=None, top_ps=None, streams=None,
                            key=None, gstate0=None, gtrans=None, gmask=None):
        """Speculative verify (the reference's gpt.py:650, eager):
        score all k+1 positions of every slot — the frontier token and k
        proposals — in ONE ragged step, then accept the longest prefix of
        proposals that equals the model's own picks.

        tok0 / pos0 [S] (frontier token and its write position), drafts
        [S, k] (entries at or past `width` ignored), width [S] (proposals
        processed: positions pos0+1..pos0+width get KV written), rem [S]
        (at most this many tokens may be emitted), fin0 [S] bool (True =
        dead slot), eos_ids [S] (-1 = none), page_tables [S, MP]: tensors
        on the pools' device. temps / top_ps [S] f32, streams [S] int and
        key (the engine's [2] int64 key, or None when every row is
        greedy) feed the keyed pick of every position, as the reference
        does (gpt.py:767-769): each row's stream, and position posf + 1;
        with no key, temps may lie on the CPU (see `sample_tokens`). kv /
        kv_scales are updated IN PLACE.

        gstate0 / gtrans / gmask (structured decoding, all three or none;
        see `_paged_decode_fused`): the k+1 DFA states of each slot are
        chained through its drafts (st_{j+1} = gtrans[st_j, drafts[:, j]],
        the reference's gpt.py:755-766) and each flat row's logits masked
        before its pick. Up to the first rejected draft these are the true
        states; later ones are garbage whose picks are never emitted. The
        drafts are valid token ids: a draft model's proposals after its
        eos come as token 0 (`speculative._ProposeStep.drafts`), so the
        chain's gather stays in range.

        Flat layout slot-major [S·(k+1)]: row s·(k+1)+j holds the token
        at position pos0[s]+j with kv_len pos0[s]+j+1, so each proposal
        attends to the earlier ones written in this same step and never
        to later ones; invalid rows (dead slots, j > width) write the
        trash page at kv_len 0. Rejected rows' KV stays in the pool past
        the accepted frontier, never attended and overwritten by position
        later. Returns (emits [k+1, S] int32 — column s holds the
        accepted picks, 1..k+1 tokens, then -1; the emitted eos is kept
        and nothing after it — kv, kv_scales)."""
        S = tok0.shape[0]
        Q = int(k) + 1
        T = S * Q
        dev = tok0.device
        i32 = torch.int32
        live = ~fin0
        j = torch.arange(Q, dtype=i32, device=dev)
        pt = page_tables.to(i32)
        drafts = drafts.to(i32)
        tok_mat = torch.cat([tok0[:, None].to(i32), drafts], dim=1)
        valid = live[:, None] & (j[None, :] <= width[:, None])   # [S, Q]
        pos_mat = pos0[:, None].to(i32) + j[None, :]
        zero = torch.zeros((), dtype=i32, device=dev)
        sid = torch.arange(S, dtype=i32, device=dev).repeat_interleave(Q)
        tokf = torch.where(valid, tok_mat, zero).reshape(T)
        posf = torch.where(valid, pos_mat, zero).reshape(T)
        validf = valid.reshape(T)
        page = pt[sid.long(), (posf // page_size).long()]
        widx = torch.where(validf, page * page_size + posf % page_size, zero)
        klen = torch.where(validf, posf + 1, zero)
        logits, *_ = self._paged_decode_core(
            tokf, posf, sid, widx, pt, klen,
            torch.arange(T, dtype=i32, device=dev), kv, kv_scales=kv_scales,
            max_q_per_slot=Q)
        lv = logits[0].float()                                   # [T, V]
        def per_row(x):
            return None if x is None else x.repeat_interleave(Q)

        allowed = None
        if gtrans is not None:
            sts = [gstate0.to(i32)]
            for jj in range(int(k)):
                sts.append(gtrans[sts[-1].long(), drafts[:, jj].long()])
            allowed = grammar_allowed(gmask, torch.stack(sts, dim=1)
                                      .reshape(T), lv.shape[1])
        picks = sample_tokens(lv, per_row(temps), per_row(top_ps),
                              per_row(streams), posf + 1, key,
                              allowed=allowed).reshape(S, Q)
        # longest matching proposal prefix, clamped to the window width
        match = (drafts == picks[:, :k]) & (
            torch.arange(int(k), dtype=i32, device=dev)[None, :]
            < width[:, None])
        a = torch.cumprod(match.to(i32), dim=1).sum(dim=1)       # accepted
        n_emit = torch.where(live, torch.minimum(a + 1, rem.to(a.dtype)),
                             torch.zeros_like(a))
        # in-step EOS masking: the emitted eos is kept, every later pick
        # of the window is suppressed (exclusive cumsum)
        is_eos = ((eos_ids[:, None] >= 0)
                  & (picks == eos_ids[:, None])).to(i32)
        eos_before = torch.cumsum(is_eos, dim=1) - is_eos
        emit_mask = (j[None, :] < n_emit[:, None]) & (eos_before == 0)
        emits = torch.where(emit_mask, picks, torch.full_like(picks, -1))
        return emits.t(), kv, kv_scales


class GPTPretrainingCriterion(nn.Module):
    """Shifted next-token cross entropy, mean over every position."""

    def __init__(self):
        super().__init__()
        self.ce = ParallelCrossEntropy()

    def forward(self, logits, labels):
        loss = self.ce(logits[:, :-1], labels[:, 1:])
        return loss.mean()
