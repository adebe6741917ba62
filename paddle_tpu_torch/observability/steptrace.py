"""The train-step FLOPs accountant (counterpart of
paddle_tpu/observability/steptrace.py:348-364, the port's own copy)."""

__all__ = ["model_flops"]


def _cfg_get(config, name, default=None):
    if isinstance(config, dict):
        return config.get(name, default)
    return getattr(config, name, default)


def model_flops(config, batch, seq):
    """Analytic fwd+bwd FLOPs of one decoder-transformer train step:
    6·P per token for the matmuls (fwd 2P + bwd 4P) plus the causal
    attention scores/context terms. `config` is any object/dict with
    hidden_size, num_layers, vocab_size and (optionally) ffn_size."""
    d = int(_cfg_get(config, "hidden_size"))
    L = int(_cfg_get(config, "num_layers"))
    v = int(_cfg_get(config, "vocab_size"))
    ffn = int(_cfg_get(config, "ffn_size", 4 * d) or 4 * d)
    per_layer = 4 * d * d + 2 * d * ffn   # qkv+proj, fc1+fc2 weights
    p_matmul = L * per_layer + v * d      # + tied lm head
    tokens = int(batch) * int(seq)
    matmul = 6 * p_matmul * tokens
    attn = L * batch * (4 * seq * seq * d) * 3 * 0.5  # fwd+2×bwd, causal
    return matmul + attn
