"""Beam search: the PyTorch port's `nn.decode` (`BeamSearchDecoder`,
`dynamic_decode`) and `F.gather_tree` against the JAX package's on CPU.

The same callable cell — h' = tanh(x W + h U), logits h' P, tokens
embedded by E — is built in both packages from one set of numpy weights;
beams and lengths must be equal and the final beam scores within 1e-5.
Mirrors tests/test_nn_functional_extras.py's gather_tree and beam
search cases.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the suite runs in several
    worker processes at once, and torch's thread pool oversubscribes the
    cores then (small ops slow down tenfold); results do not change."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _serial_mesh():
    from paddle_tpu.distributed import mesh as mesh_mod

    mesh_mod.reset_mesh()
    yield


def _weights(seed, V, D, H):
    rng = np.random.default_rng(seed)
    return {"E": rng.standard_normal((V, D)).astype(np.float32),
            "W": (rng.standard_normal((D, H)) * 0.5).astype(np.float32),
            "U": (rng.standard_normal((H, H)) * 0.5).astype(np.float32),
            "P": (rng.standard_normal((H, V)) * 2.0).astype(np.float32)}


def _jax_decoder(w, beam, end):
    E, W, U, P = (paddle.to_tensor(w[k]) for k in "EWUP")

    def cell(x, h):
        h2 = paddle.tanh(paddle.matmul(x, W) + paddle.matmul(h, U))
        return h2, h2

    return jnn.BeamSearchDecoder(
        cell, start_token=0, end_token=end, beam_size=beam,
        embedding_fn=lambda ids: JF.embedding(ids, E),
        output_fn=lambda h: paddle.matmul(h, P))


def _torch_decoder(w, beam, end):
    E, W, U, P = (torch.from_numpy(w[k]) for k in "EWUP")

    def cell(x, h):
        h2 = torch.tanh(x @ W + h @ U)
        return h2, h2

    return tnn.BeamSearchDecoder(
        cell, start_token=0, end_token=end, beam_size=beam,
        embedding_fn=lambda ids: TF.embedding(ids, E),
        output_fn=lambda h: h @ P)


@pytest.mark.parametrize("seed,beam,end,steps", [
    (0, 3, 1, 6), (1, 4, 2, 9), (2, 2, 5, None)])
def test_beam_search_matches_reference(seed, beam, end, steps):
    V, D, H, B = 11, 8, 8, 2
    w = _weights(seed, V, D, H)
    h0 = np.random.default_rng(seed + 10).standard_normal(
        (B, H)).astype(np.float32)
    jout, jst, jlen = jnn.dynamic_decode(
        _jax_decoder(w, beam, end), inits=paddle.to_tensor(h0),
        max_step_num=steps if steps else 30, return_length=True)
    tout, tst, tlen = tnn.dynamic_decode(
        _torch_decoder(w, beam, end), inits=torch.from_numpy(h0),
        max_step_num=steps if steps else 30, return_length=True)
    jids = np.asarray(jout.numpy())
    assert tout.shape == jids.shape and tout.shape[0] == B
    assert tout.shape[2] == beam
    np.testing.assert_array_equal(tout.numpy(), jids)
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen.numpy()))
    # final beam scores (log-probs) and finished flags
    np.testing.assert_allclose(tst[1].numpy(), np.asarray(jst[1]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tst[2].numpy(), np.asarray(jst[2]))
    # time-major output: the same ids, steps first
    tmaj, _ = tnn.dynamic_decode(
        _torch_decoder(w, beam, end), inits=torch.from_numpy(h0),
        max_step_num=steps if steps else 30, output_time_major=True)
    np.testing.assert_array_equal(tmaj.movedim(0, 1).numpy(), jids)


def test_gather_tree_reference_example():
    ids = np.array([[[2, 2], [6, 1]], [[3, 9], [6, 1]], [[0, 1], [9, 0]]])
    parents = np.array(
        [[[0, 0], [1, 1]], [[1, 0], [1, 0]], [[0, 0], [0, 1]]])
    out = TF.gather_tree(torch.from_numpy(ids), torch.from_numpy(parents))
    ref = JF.gather_tree(paddle.to_tensor(ids), paddle.to_tensor(parents))
    assert out.tolist() == [[[2, 2], [1, 6]], [[3, 3], [6, 1]],
                            [[0, 1], [9, 0]]]
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref.numpy()))


def test_tile_beam_merge_and_nested_states():
    """`tile_beam_merge_with_batch` repeats each sample beam times; a
    cell whose states are a dict of tensors is reordered by parent like
    a single tensor."""
    t = tnn.BeamSearchDecoder.tile_beam_merge_with_batch(
        torch.tensor([[1.0], [2.0]]), 3)
    j = jnn.BeamSearchDecoder.tile_beam_merge_with_batch(
        paddle.to_tensor(np.array([[1.0], [2.0]], np.float32)), 3)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j.numpy()))
    w = _weights(5, 9, 6, 6)
    E, W, U, P = (torch.from_numpy(w[k]) for k in "EWUP")

    def cell(x, st):
        h2 = torch.tanh(x @ W + st["h"] @ U)
        return h2, {"h": h2, "n": st["n"] + 1}

    dec = tnn.BeamSearchDecoder(cell, 0, 1, 2,
                                embedding_fn=lambda i: TF.embedding(i, E),
                                output_fn=lambda h: h @ P)
    h0 = torch.zeros((3, 6))
    out, (cell_st, scores, fin) = tnn.dynamic_decode(
        dec, inits={"h": h0, "n": torch.zeros((3,), dtype=torch.int64)},
        max_step_num=4)
    assert out.shape[0] == 3 and out.shape[2] == 2
    assert cell_st["h"].shape == (6, 6)
    assert (cell_st["n"] == out.shape[1]).all()
    assert torch.isfinite(scores).all() and fin.dtype == torch.bool
