"""jax's threefry PRNG and the keyed sampler: the PyTorch port
(`paddle_tpu_torch.core.prng`, `sample_tokens`) against jax 0.9 and the
JAX package's `sample_tokens` on CPU.

Keys, `fold_in`, bits and uniforms must be bit-equal. Gumbel noise is
-log(-log(u)); jax's CPU log (XLA's) is within 1 ulp of the exact value
but not correctly rounded, torch's nearly always is, so the two noises
are held to 2 ulps of max(|g|, 1) — two logs of one ulp each — and the
logs themselves to 1 ulp. Categorical draws and `sample_tokens` must pick
the same tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.text.models.gpt import sample_tokens as jax_sample_tokens
from paddle_tpu_torch.core import prng
from paddle_tpu_torch.text.models.gpt import sample_tokens

pytestmark = pytest.mark.torch_port

TINY = np.finfo(np.float32).tiny
SEEDS = (0, 7, 2**31 - 1, 2**32 + 5)


def _key_data(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def test_threefry_partitionable_is_the_layout_ported():
    # the port follows jax 0.9's default bit layout; an upgrade that
    # changes it must fail here, not as silently different tokens
    assert jax.config.jax_threefry_partitionable is True


def test_threefry2x32_known_answers():
    """The Random123 known-answer vectors of threefry2x32-20, and jax's
    own hash on random words."""
    from jax._src import prng as jprng

    m = 0xFFFFFFFF
    for key, ctr, want in (((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
                           ((m, m), (m, m), (0x1CB996FC, 0xBB002BE7)),
                           ((0x13198A2E, 0x03707344),
                            (0x243F6A88, 0x85A308D3),
                            (0xC4923A9C, 0x483DF7A0))):
        got = prng.threefry2x32(*(torch.tensor(v) for v in key + ctr))
        assert tuple(int(g) for g in got) == want
    rng = np.random.default_rng(0)
    k = rng.integers(0, 2**32, (2,), dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 2**32, (2, 64), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jprng.threefry_2x32(jnp.asarray(k),
                                          jnp.asarray(x.reshape(-1))))
    y1, y2 = prng.threefry2x32(*(torch.tensor(int(v)) for v in k),
                               *torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(torch.cat([y1, y2]).numpy(),
                                  want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(prng.prng_key(seed).numpy(),
                                  _key_data(jax.random.PRNGKey(seed)))


def test_fold_in_chains_match_jax():
    """fold_in(fold_in(key, stream), position) for 16 streams x 16
    positions, vectorised over rows as the sampler folds them."""
    key = jax.random.PRNGKey(1234)
    streams = np.repeat(np.arange(16), 16) * 977
    positions = np.tile(np.arange(16), 16) * 65537 + 2**31 - 20
    want = jax.vmap(lambda s, p: jax.random.fold_in(
        jax.random.fold_in(key, s), p))(
            jnp.asarray(streams, jnp.uint32),
            jnp.asarray(positions, jnp.uint32))
    got = prng.fold_in(prng.fold_in(prng.prng_key(1234),
                                    torch.from_numpy(streams)),
                       torch.from_numpy(positions))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_match_jax(seed):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    want = np.asarray(jax.random.bits(key, (2048,), dtype=jnp.uint32))
    got = prng.random_bits(torch.from_numpy(_key_data(key)), 2048)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("minval", [0.0, TINY])
def test_uniform_bit_equal(minval):
    """[minval, 1) — the sampler's range (tiny) and the default — bit for
    bit."""
    for seed in SEEDS:
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
        want = np.asarray(jax.random.uniform(key, (50000,), jnp.float32,
                                             minval, 1.0))
        got = prng.uniform(torch.from_numpy(_key_data(key)), 50000, minval,
                           1.0).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def test_gumbel_within_two_ulps():
    worst, equal, n = 0.0, 0, 0
    for seed in SEEDS:
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
        want = np.asarray(jax.random.gumbel(key, (50000,), jnp.float32))
        got = prng.gumbel(torch.from_numpy(_key_data(key)), 50000).numpy()
        ulps = np.abs(got - want) / np.spacing(
            np.maximum(np.abs(want), 1).astype(np.float32))
        worst = max(worst, float(ulps.max()))
        equal += int((got == want).sum())
        n += got.size
        # the source of the difference: each log within 1 ulp
        u = prng.uniform(torch.from_numpy(_key_data(key)), 50000, TINY, 1.0)
        jl = np.asarray(jnp.log(jnp.asarray(u.numpy())))
        tl = torch.log(u).numpy()
        assert np.abs(jl.view(np.int32) - tl.view(np.int32)).max() <= 1
    assert worst <= 2.0, worst
    assert equal / n > 0.5, equal / n


def test_categorical_matches_jax():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((64, 2048)) * 3).astype(np.float32)
    key = jax.random.PRNGKey(99)
    keys = jax.vmap(lambda s: jax.random.fold_in(key, s))(
        jnp.arange(64, dtype=jnp.uint32))
    want = np.asarray(jax.vmap(jax.random.categorical)(keys,
                                                       jnp.asarray(logits)))
    got = prng.categorical(prng.fold_in(prng.prng_key(99), torch.arange(64)),
                           torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sample_tokens_matches_reference_on_50_seeded_batches():
    """The reference's `sample_tokens` (jitted, as its host tick runs it)
    and the port's on [8, 2048] logits: mixed temperatures (greedy rows
    among them), top_p from 0.1 to 1, random streams and positions, 64-bit
    seeds. Every row's token equal."""
    fn = jax.jit(jax_sample_tokens)
    temps0 = np.array([0, 0.5, 0.8, 1.3, 1.0, 0.7, 2.0, 0.3], np.float32)
    tops0 = np.array([1.0, 0.9, 0.5, 0.95, 0.1, 1.0, 0.7, 0.99], np.float32)
    for seed in range(50):
        rng = np.random.default_rng(seed)
        logits = (rng.standard_normal((8, 2048))
                  * rng.uniform(0.5, 4)).astype(np.float32)
        temps = temps0[rng.permutation(8)]
        tops = tops0[rng.permutation(8)]
        streams = rng.integers(0, 1000, (8,)).astype(np.int32)
        pos = rng.integers(0, 2**31 - 1, (8,)).astype(np.int32)
        ks = int(rng.integers(0, 2**40))
        want = np.asarray(fn(*(jnp.asarray(x) for x in (logits, temps, tops,
                                                         streams, pos)),
                             jax.random.PRNGKey(ks)))
        got = sample_tokens(*(torch.from_numpy(x) for x in (logits, temps,
                                                             tops, streams,
                                                             pos)),
                            prng.prng_key(ks))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(seed))
