"""Dense generation over a static KV cache: the PyTorch port's
`GPTForCausalLM.generate` against the JAX package's on CPU (gpt_tiny,
the same weights in both).

Greedy tokens equal; sampled tokens (temperature, top-k) equal when the
same seed is set just before each call — the port draws with
`core.rng.next_key`, jax's fold_in(PRNGKey(seed), index), and
`core.prng`'s Gumbel field (within 2 ulps of XLA's CPU log, ROADMAP §C:
the picks below are equal); the edge cases and their errors; the eos
early stop; a ragged left-padded batch against per-example runs; and the
step object reused across calls. Mirrors the generate cases of
tests/test_text_models.py.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.text.models import GPTForCausalLM as JaxGPT
from paddle_tpu.text.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.convert import export_state_dict
from paddle_tpu_torch.core import rng as trng
from paddle_tpu_torch.text.models.gpt import GPTForCausalLM, gpt_tiny

pytestmark = pytest.mark.torch_port

VOCAB = 2048


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module (several test workers share
    the cores); results do not change."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _serial_mesh():
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh_mod.reset_mesh()
    yield


@pytest.fixture(scope="module")
def pair():
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh_mod.reset_mesh()
    tm = GPTForCausalLM(gpt_tiny(), device="cpu", seed=61)
    jm = JaxGPT(jax_gpt_tiny())
    jm.set_state_dict({k: paddle.to_tensor(v)
                       for k, v in export_state_dict(tm).items()})
    jm.eval()
    return jm, tm


def _ids(seed, b, s):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, s)).astype(
        np.int32)


def _jgen(jm, ids, **kw):
    if "attention_mask" in kw:
        kw["attention_mask"] = paddle.to_tensor(kw["attention_mask"])
    return np.asarray(jm.generate(paddle.to_tensor(ids), **kw).numpy())


def _tgen(tm, ids, **kw):
    return tm.generate(ids, **kw).cpu().numpy()


@pytest.mark.parametrize("b,s,new", [(1, 5, 6), (3, 12, 10)])
def test_greedy_matches_reference(pair, b, s, new):
    jm, tm = pair
    ids = _ids(b + s, b, s)
    ref = _jgen(jm, ids, max_new_tokens=new)
    out = _tgen(tm, ids, max_new_tokens=new)
    assert out.dtype == np.int64 and out.shape == (b, s + new)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("temperature,top_k", [(0.8, None), (1.3, 20)])
def test_sampled_matches_reference_under_the_same_seed(pair, temperature,
                                                       top_k):
    jm, tm = pair
    ids = _ids(7, 2, 6)
    kw = dict(max_new_tokens=8, do_sample=True, temperature=temperature,
              top_k=top_k)
    paddle.seed(123)
    ref = _jgen(jm, ids, **kw)
    trng.seed(123)
    out = _tgen(tm, ids, **kw)
    np.testing.assert_array_equal(out, ref)
    trng.seed(124)
    assert not np.array_equal(_tgen(tm, ids, **kw), out)
    # temperature 0 is greedy whatever do_sample says
    np.testing.assert_array_equal(
        _tgen(tm, ids, max_new_tokens=8, do_sample=True, temperature=0),
        _tgen(tm, ids, max_new_tokens=8))


def test_edge_cases_match_reference(pair):
    jm, tm = pair
    ids = _ids(3, 2, 4)
    # no budget: the prompt comes back as int64
    out = _tgen(tm, ids, max_new_tokens=0)
    np.testing.assert_array_equal(out, _jgen(jm, ids, max_new_tokens=0))
    assert out.dtype == np.int64
    # the total is capped at max_seq_len (256)
    long = _ids(4, 1, 250)
    out = _tgen(tm, long, max_new_tokens=20)
    assert out.shape == (1, 256)
    np.testing.assert_array_equal(out, _jgen(jm, long, max_new_tokens=20))
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        tm.generate(_ids(5, 1, 257))
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        _jgen(jm, _ids(5, 1, 257))
    bad_masks = {
        "LEFT-padded": np.array([[1, 0, 1, 1], [1, 1, 1, 1]]),
        "all-zero row": np.array([[0, 0, 0, 0], [1, 1, 1, 1]]),
        "shape": np.ones((2, 3), np.int32),
    }
    for msg, mask in bad_masks.items():
        with pytest.raises(ValueError, match=msg):
            tm.generate(ids, attention_mask=mask)
        with pytest.raises(ValueError, match=msg):
            _jgen(jm, ids, attention_mask=mask)


def test_eos_early_stop_matches_reference(pair):
    """A row that generates eos emits pad after it; the loop stops when
    every row is finished, so the result is shorter."""
    jm, tm = pair
    ids = _ids(11, 2, 6)
    free = _tgen(tm, ids, max_new_tokens=12)
    gen0 = list(free[0, 6:])
    # a token row 0 first emits at step j + 1 > 1
    j = next(j for j in range(1, 12) if gen0[j] not in gen0[:j])
    eos = int(gen0[j])
    for pad in (None, 7):
        ref = _jgen(jm, ids, max_new_tokens=12, eos_token_id=eos,
                    pad_token_id=pad)
        out = _tgen(tm, ids, max_new_tokens=12, eos_token_id=eos,
                    pad_token_id=pad)
        np.testing.assert_array_equal(out, ref)
        fill = eos if pad is None else pad
        assert (out[0, 6 + j + 1:] == fill).all()
    # a lone row stops at once: the output ends at the eos step
    one = _ids(11, 1, 6)
    out = _tgen(tm, one, max_new_tokens=12, eos_token_id=eos)
    assert out.shape == (1, 6 + j + 1) and out[0, -1] == eos
    np.testing.assert_array_equal(
        out, _jgen(jm, one, max_new_tokens=12, eos_token_id=eos))


def test_ragged_left_padded_batch_matches_per_example_runs(pair):
    jm, tm = pair
    rng = np.random.default_rng(17)
    lens = [9, 4, 6]
    width = max(lens)
    ids = np.zeros((3, width), np.int32)
    mask = np.zeros((3, width), np.int32)
    rows = []
    for i, L in enumerate(lens):
        row = rng.integers(0, VOCAB, (L,)).astype(np.int32)
        rows.append(row)
        ids[i, width - L:] = row
        mask[i, width - L:] = 1
    out = _tgen(tm, ids, max_new_tokens=7, attention_mask=mask)
    np.testing.assert_array_equal(
        out, _jgen(jm, ids, max_new_tokens=7, attention_mask=mask))
    for i, row in enumerate(rows):
        alone = _tgen(tm, row[None], max_new_tokens=7)
        np.testing.assert_array_equal(out[i, width:], alone[0, len(row):])
    # an all-ones mask is the unpadded path
    np.testing.assert_array_equal(
        _tgen(tm, ids, max_new_tokens=3, attention_mask=np.ones_like(ids)),
        _tgen(tm, ids, max_new_tokens=3))


def test_step_reused_across_calls(pair):
    """One `_DecodeStep` per (batch, cache_len, padded, dtype): calls
    whose totals round to the same cache length reuse it (a stale cache
    from the last call never leaks: its rows lie past the causal
    mask), and a new batch size or cache length builds another."""
    _, tm = pair
    tm.__dict__.pop("_decode_steps", None)
    ids = _ids(23, 2, 10)
    a = _tgen(tm, ids, max_new_tokens=20)
    b = _tgen(tm, ids, max_new_tokens=40)
    np.testing.assert_array_equal(b[:, :30], a)
    steps = tm._decode_steps
    assert len(steps) == 1
    (step,) = steps.values()
    assert step.caches[0].shape == (2, 128, 4, 32)
    _tgen(tm, ids, max_new_tokens=200)        # 210 -> cache_len 256
    _tgen(tm, ids[:1], max_new_tokens=5)
    assert len(steps) == 3
    assert step.captures == 0 and step.replays == 0     # CPU: eager
