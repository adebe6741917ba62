"""BERT / ERNIE — the bidirectional encoder pretraining family
(counterpart of paddle_tpu/text/models/bert.py).

Same configurations, parameter names and layouts as the JAX package, so
a reference model's `state_dict()` loads key for key
(`convert.load_jax_state_dict`), and the same calls into the tensor API
(`ops.creation`, `ops.manipulation`, `ops.math`) where the reference
makes them. One model runs serial and at mp > 1: the fused qkv,
`proj`, `fc1` / `fc2` and the word embedding are the Megatron layers of
`mp_layers`, each holding this rank's shard (`convert.cut_bert_state`
cuts a whole state dict), and the MLM logits against the vocab-sharded
tied embedding go through `BertPretrainingCriterion`'s vocab-parallel
CE.

Attention follows the reference's mask rules: no mask, or a 1-D integer
`attention_mask` of per-example valid lengths (prefix key padding),
takes the flash attention kernels — bidirectional, K3 forward and K4 /
K5 backward on a CUDA tensor, with `kv_lens` for the lengths; a 2-D
[b, s] keep-mask becomes the additive [b, 1, 1, s] mask of the dense
path. A float 1-D mask raises the reference's ValueError.

The models are built on CUDA unless `device="cpu"` asks for the CPU
(raising without a GPU), their weights drawn from `seed` through an
explicit generator: N(0, 0.02) for matrices and embeddings, ones /
zeros for LayerNorm, zero biases. Dropout draws from the generator
`core.rng.generator_scope` installs (TrainStep installs one a step).
"""
import torch
from torch import nn

from ... import nn as pnn
from ...core.dtype import resolve_dtype
from ...core.place import resolve_device
from ...distributed import mesh as mesh_mod
from ...distributed.fleet.meta_parallel.mp_layers import (
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding, mp_degree, shard_activation, split_fused_qkv)
from ...distributed.fleet.meta_parallel.mp_ops import copy_to_mp
from ...nn import functional as F
from ...nn.layer.layers import Layer
from ...ops import creation
from ...ops import manipulation as manip
from ...ops import math as pmath

__all__ = [
    "BertConfig", "BertModel", "BertForPretraining",
    "BertPretrainingCriterion", "BertForSequenceClassification",
    "ErnieModel", "ErnieForPretraining", "bert_tiny", "bert_base",
    "ernie_3_base",
]


class BertConfig:
    def __init__(self, vocab_size=30528, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=None, max_position=512,
                 type_vocab_size=2, dropout=0.0, pool_act="tanh"):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.max_position = max_position
        self.type_vocab_size = type_vocab_size
        self.dropout = dropout
        self.pool_act = pool_act


def bert_tiny(**kw):
    return BertConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                      num_heads=4, max_position=128, **kw)


def bert_base(**kw):
    return BertConfig(vocab_size=30528, hidden_size=768, num_layers=12,
                      num_heads=12, max_position=512, **kw)


def ernie_3_base(**kw):
    """ERNIE-3.0-base shape (BERT-base-sized encoder, 40k vocab)."""
    return BertConfig(vocab_size=40000, hidden_size=768, num_layers=12,
                      num_heads=12, max_position=2048, **kw)


def _kw(device, dtype):
    return {"device": device, "dtype": dtype}


class _Built(Layer):
    """A model entry point: resolves its device and dtype, and draws its
    weights from `seed` once built (a sub-model built with seed None
    leaves that to its owner)."""

    def _resolve(self, device, dtype):
        return resolve_device(device), resolve_dtype(dtype)

    @torch.no_grad()
    def reset_parameters(self, seed=0):
        dev = next(iter(self.parameters())).device
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        for name, p in self.named_parameters():
            if ".ln" in name or name.startswith("mlm_ln."):
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=gen)


class BertEmbeddings(Layer):
    """word + position + token-type embeddings → LN → dropout."""

    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        kw = _kw(device, dtype)
        self.word = VocabParallelEmbedding(config.vocab_size,
                                           config.hidden_size, **kw)
        self.position = pnn.Embedding(config.max_position,
                                      config.hidden_size, **kw)
        self.token_type = pnn.Embedding(config.type_vocab_size,
                                        config.hidden_size, **kw)
        self.ln = pnn.LayerNorm(config.hidden_size, **kw)
        self.drop = pnn.Dropout(config.dropout)

    def forward(self, input_ids, token_type_ids=None):
        s = input_ids.shape[1]
        pos = creation.arange(0, s, dtype="int64", device=input_ids.device)
        if token_type_ids is None:
            token_type_ids = creation.zeros_like(input_ids)
        x = pmath.add(pmath.add(self.word(input_ids), self.position(pos)),
                      self.token_type(token_type_ids))
        return self.drop(self.ln(x))


class BertEncoderLayer(Layer):
    """Post-LN encoder block (BERT convention), fused qkv, bidirectional
    attention with an additive padding mask or per-example lengths."""

    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        kw = _kw(device, dtype)
        d = config.hidden_size
        mp, _ = mp_degree()
        if config.num_heads % mp:
            raise ValueError(f"num_heads={config.num_heads} not divisible "
                             f"by mp={mp}")
        # at mp > 1 this rank's heads of each of q, k and v
        # (mp_layers.qkv_shard_columns)
        self.nh = config.num_heads // mp
        self.hd = d // config.num_heads
        self.qkv = ColumnParallelLinear(d, 3 * d, gather_output=False, **kw)
        self.proj = RowParallelLinear(d, d, input_is_parallel=True, **kw)
        self.ln1 = pnn.LayerNorm(d, **kw)
        self.fc1 = ColumnParallelLinear(d, config.intermediate_size,
                                        gather_output=False, **kw)
        self.fc2 = RowParallelLinear(config.intermediate_size, d,
                                     input_is_parallel=True, **kw)
        self.ln2 = pnn.LayerNorm(d, **kw)
        self.dropout = pnn.Dropout(config.dropout)

    def forward(self, x, attn_mask=None, kv_lens=None):
        b, s = x.shape[0], x.shape[1]
        q, k, v = split_fused_qkv(self.qkv(x), b, s, self.nh, self.hd)
        attn = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                              kv_lens=kv_lens)
        attn = manip.reshape(attn, [b, s, self.nh * self.hd])
        x = self.ln1(pmath.add(x, self.dropout(self.proj(attn))))
        h = self.fc2(F.gelu(self.fc1(x)))
        return self.ln2(pmath.add(x, self.dropout(h)))


class BertModel(_Built):
    """Embeddings → N encoder layers → (sequence_output, pooled)."""

    def __init__(self, config, device=None, dtype="float32", seed=0):
        super().__init__()
        device, dtype = self._resolve(device, dtype)
        kw = _kw(device, dtype)
        self.config = config
        self.embeddings = BertEmbeddings(config, **kw)
        self.layers = nn.ModuleList(
            [BertEncoderLayer(config, **kw)
             for _ in range(config.num_layers)])
        self.pooler = pnn.Linear(config.hidden_size, config.hidden_size,
                                 **kw)
        if seed is not None:
            self.reset_parameters(seed)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        mask, kv_lens = None, None
        if attention_mask is not None and len(attention_mask.shape) == 1:
            # [b] int lengths (prefix key padding): the flash kernels
            # take them as kv_lens
            if "int" not in str(attention_mask.dtype):
                raise ValueError(
                    "a rank-1 attention_mask is interpreted as per-example "
                    "valid LENGTHS and must be integer; got "
                    f"{attention_mask.dtype} (a squeezed [s] keep-mask is "
                    "not supported — pass the [b, s] form)")
            kv_lens = attention_mask
        elif attention_mask is not None:
            # [b, s] 1/0 keep-mask → additive [b, 1, 1, s]
            m = manip.reshape(
                manip.cast(attention_mask, "float32"),
                [attention_mask.shape[0], 1, 1, attention_mask.shape[1]])
            mask = pmath.multiply(pmath.subtract(m, 1.0), 1e9)
        x = self.embeddings(input_ids, token_type_ids)
        x = shard_activation(x, "dp", "sp", None)
        for layer in self.layers:
            x = layer(x, attn_mask=mask, kv_lens=kv_lens)
        pooled = F.tanh(self.pooler(
            manip.squeeze(manip.slice(x, [1], [0], [1]), [1])))
        return x, pooled


class BertForPretraining(_Built):
    """MLM head (transform + tied vocab-sharded decoder) + NSP head."""

    def __init__(self, config, device=None, dtype="float32", seed=0):
        super().__init__()
        device, dtype = self._resolve(device, dtype)
        kw = _kw(device, dtype)
        self.config = config
        self.bert = BertModel(config, device=device, dtype=dtype, seed=None)
        d = config.hidden_size
        self.mlm_transform = pnn.Linear(d, d, **kw)
        self.mlm_ln = pnn.LayerNorm(d, **kw)
        self.nsp = pnn.Linear(d, 2, **kw)
        if seed is not None:
            self.reset_parameters(seed)

    def _mlm_hidden(self, seq):
        return self.mlm_ln(F.gelu(self.mlm_transform(seq)))

    def forward(self, input_ids, token_type_ids=None,
                attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        h = self._mlm_hidden(seq)
        w = self.bert.embeddings.word.weight  # [vocab(/mp), d]
        # at mp > 1 this rank's vocab columns; h's gradient all-reduced
        mlm_logits = F.linear(copy_to_mp(h), manip.transpose(w, [1, 0]))
        mlm_logits = shard_activation(mlm_logits, "dp", "sp", "mp")
        return mlm_logits, self.nsp(pooled)

    def fused_mlm_loss(self, input_ids, mlm_labels, token_type_ids=None,
                       attention_mask=None, nsp_labels=None,
                       block_size=4096):
        """MLM (+ optional NSP) loss with the vocab decoder and the
        softmax CE fused (`F.fused_linear_cross_entropy`): the [b, s,
        vocab] logits are never kept. Serial / dp only: at mp > 1 use
        forward() + BertPretrainingCriterion."""
        if mesh_mod.has_mesh() and mesh_mod.axis_size("mp") > 1:
            raise ValueError(
                "fused_mlm_loss computes softmax over the FULL vocab; "
                "with mp>1 the tied decoder weight is vocab-sharded and "
                "the result would be silently wrong. Use forward() + "
                "BertPretrainingCriterion (ParallelCrossEntropy) under TP.")
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        h = self._mlm_hidden(seq)
        w = self.bert.embeddings.word.weight  # [vocab, d]
        loss = F.fused_linear_cross_entropy(
            h, w, mlm_labels, transpose_weight=True, ignore_index=-100,
            block_size=block_size)
        if nsp_labels is not None:
            loss = pmath.add(loss, pmath.mean(
                F.cross_entropy(self.nsp(pooled), nsp_labels)))
        return loss


class BertPretrainingCriterion(Layer):
    """Masked-LM vocab-parallel CE (ignore_index −100) + NSP CE."""

    def __init__(self, use_nsp=True):
        super().__init__()
        self.ce = ParallelCrossEntropy()
        self.use_nsp = use_nsp

    def forward(self, mlm_logits, mlm_labels, nsp_logits=None,
                nsp_labels=None):
        # the CE gives 0 at ignore_index itself
        tok_loss = self.ce(mlm_logits, mlm_labels)  # [b, s]
        mask = manip.cast(pmath.not_equal(mlm_labels, -100), "float32")
        loss = pmath.divide(pmath.sum(tok_loss),
                            pmath.add(pmath.sum(mask), 1e-9))
        if self.use_nsp and nsp_logits is not None:
            loss = pmath.add(loss, pmath.mean(
                F.cross_entropy(nsp_logits, nsp_labels)))
        return loss


class BertForSequenceClassification(_Built):
    def __init__(self, config, num_classes=2, device=None, dtype="float32",
                 seed=0):
        super().__init__()
        device, dtype = self._resolve(device, dtype)
        self.bert = BertModel(config, device=device, dtype=dtype, seed=None)
        self.drop = pnn.Dropout(config.dropout)
        self.classifier = pnn.Linear(config.hidden_size, num_classes,
                                     **_kw(device, dtype))
        if seed is not None:
            self.reset_parameters(seed)

    def forward(self, input_ids, token_type_ids=None,
                attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.classifier(self.drop(pooled))


# ERNIE shares the BERT architecture in this generation; the difference
# (knowledge masking) lives in data preparation, not the network.
ErnieModel = BertModel
ErnieForPretraining = BertForPretraining
