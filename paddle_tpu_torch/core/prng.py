"""jax's threefry PRNG in torch integer math — the random calls the
reference's `sample_tokens` makes (paddle_tpu/text/models/gpt.py:331),
so a sampled token is the same number in both packages.

Ported from jax 0.9's code, not its docs: `threefry_seed`,
`threefry_2x32` / the threefry2x32 rounds and `_threefry_fold_in`
(jax/_src/prng.py), the *partitionable* `random_bits` layout (jax 0.9's
default: element i hashes the counter pair (0, i), and its 32 bits are
`bits1 ^ bits2`), `_uniform`, `_gumbel` in mode "low" and `categorical`
(jax/_src/random.py).

A key is an int64 tensor [..., 2] holding the two uint32 words of jax's
raw key; every function is vectorised over leading key dimensions (each
row of a batch has its own folded key). The uint32 words live in int64
and are masked back to 32 bits after each add and shift, because torch's
uint32 support is thin. No `torch.Generator`, no global state: the same
calls give the same bits on CPU and CUDA tensors.
"""
import numpy as np
import torch

__all__ = ["threefry2x32", "prng_key", "fold_in", "random_bits", "uniform",
           "gumbel", "categorical"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)


def _rotl(v, r):
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash (20 rounds) of counter words (x1, x2) under
    key words (k1, k2): int64 tensors holding uint32 values, broadcast
    together. Returns the two hashed words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def prng_key(seed, device="cpu"):
    """`jax.random.PRNGKey(seed)`'s key data: [seed >> 32, seed & 0xFFFFFFFF]
    of the seed as a 64-bit integer (jax's `threefry_seed`)."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([s >> 32, s & _M32], dtype=torch.int64,
                        device=device)


def fold_in(key, data):
    """`jax.random.fold_in(key, data)`: the hash of the counter pair
    (0, data) under `key`. key [..., 2], data an int or an integer tensor
    broadcast against key[..., 0] (taken as uint32) → keys [..., 2]."""
    if not torch.is_tensor(data):
        data = torch.tensor(int(data), device=key.device)
    data = data.to(torch.int64) & _M32
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key, n):
    """`jax.random.bits(key, (n,))` in the partitionable layout: element i
    is `bits1 ^ bits2` of the hash of (0, i). key [..., 2] → int64
    [..., n] holding uint32 values."""
    count = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[..., 0:1], key[..., 1:2],
                          torch.zeros_like(count), count)
    return b1 ^ b2


def uniform(key, n, minval=0.0, maxval=1.0):
    """`jax.random.uniform(key, (n,), float32, minval, maxval)`: the top 23
    bits as the mantissa of a float in [1, 2), minus 1, scaled, and
    clamped below at minval. key [..., 2] → float32 [..., n]."""
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    bits = (random_bits(key, n) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f * span + float(lo), float(lo))


def gumbel(key, n):
    """`jax.random.gumbel(key, (n,), float32)` in jax's default mode "low":
    -log(-log(u)) of a uniform u in [tiny, 1). key [..., 2] → float32
    [..., n]."""
    return -torch.log(-torch.log(uniform(key, n, _TINY, 1.0)))


def categorical(key, logits):
    """`jax.random.categorical(key, logits)` along the last axis — the
    Gumbel-max trick, argmax(gumbel + logits), taking the first maximal
    index. key [..., 2], logits [..., V] float32 → int64 [...]."""
    return (gumbel(key, logits.shape[-1]) + logits).argmax(dim=-1)
