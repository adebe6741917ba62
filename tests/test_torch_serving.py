"""Dynamic batching: the PyTorch port's `InferenceServer` /
`BatchingConfig` against the JAX package's on CPU.

The same MLP (paddle's `Sequential` of `Linear` / `ReLU`, the weights
carried across by `convert`) is served by both servers to concurrent
client threads; every row must equal the module's own forward and the
reference server's output within 1e-5 relative, and requests must
batch. Mirrors tests/test_inference.py's serving cases.
"""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import inference as jinf
from paddle_tpu import nn as jnn
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import load_jax_state_dict

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


@pytest.fixture(scope="module")
def mlps():
    """The reference MLP and the port's, loaded from its state_dict."""
    paddle.seed(0)
    jm = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 16),
                        jnn.ReLU(), jnn.Linear(16, 4))
    jm.eval()
    tm = tnn.Sequential(tnn.Linear(8, 16, device="cpu"), tnn.ReLU(),
                        tnn.Linear(16, 16, device="cpu"), tnn.ReLU(),
                        tnn.Linear(16, 4, device="cpu"))
    load_jax_state_dict(tm, {k: np.asarray(v.numpy())
                             for k, v in jm.state_dict().items()})
    return jm, tm


def _clients(server, xs, n_clients):
    per = len(xs) // n_clients
    results, lock = {}, threading.Lock()

    def client(lo):
        futs = [(i, server.submit(xs[i])) for i in range(lo, lo + per)]
        for i, f in futs:
            out = f.result(timeout=60)[0]
            with lock:
                results[i] = out

    threads = [threading.Thread(target=client, args=(k * per,))
               for k in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return np.stack([results[i] for i in range(len(xs))])


def test_sequential_and_convert_match_reference(mlps):
    jm, tm = mlps
    assert [n for n, _ in tm.named_parameters()] == list(
        jm.state_dict().keys())
    x = np.random.default_rng(1).standard_normal((5, 8)).astype(np.float32)
    with torch.inference_mode():
        out = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, jm(paddle.to_tensor(x)).numpy(),
                               rtol=1e-5, atol=1e-6)
    assert isinstance(tm[1], tnn.ReLU) and len(tm) == 5


def test_concurrent_correctness_and_batching(mlps):
    jm, tm = mlps
    xs = np.random.default_rng(0).standard_normal((60, 8)).astype(
        np.float32)
    with torch.inference_mode():
        own = tm(torch.from_numpy(xs)).numpy()
    cfg = dict(max_batch_size=16, max_delay_ms=10.0)
    tserver = tinf.InferenceServer(tm, tinf.BatchingConfig(**cfg))
    jserver = jinf.InferenceServer(jm, jinf.BatchingConfig(**cfg))
    with tserver:
        tout = _clients(tserver, xs, 3)
    with jserver:
        jout = _clients(jserver, xs, 3)
    np.testing.assert_allclose(tout, own, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-6)
    st = tserver.stats
    assert st["requests"] == 60 and st["batches"] < 60
    assert tserver.mean_batch_size > 1.0
    assert st["rows_padded"] >= 0


def test_batching_config_matches_reference():
    for kw in ({}, {"max_batch_size": 64}, {"max_batch_size": 5},
               {"max_batch_size": 12, "buckets": [4, 12]}):
        t, j = tinf.BatchingConfig(**kw), jinf.BatchingConfig(**kw)
        assert t.buckets == j.buckets
        for n in (1, 3, 5, 12, 40):
            assert t.bucket_for(n) == j.bucket_for(n)
    with pytest.raises(ValueError, match="largest bucket"):
        tinf.BatchingConfig(max_batch_size=8, buckets=[1, 2])


def test_callable_source_groups_signatures_and_errors(mlps, tmp_path):
    """A callable serves too; requests of two shapes run in separate
    batches, a bad request fails only its own future, a Predictor loaded
    from disk serves with its batches padded to the exported batch size,
    and a server that is not started refuses."""
    def fn(x):
        if x.shape[-1] == 3:
            raise ValueError("bad width")
        return x * 2.0, x.sum(axis=-1)

    server = tinf.InferenceServer(fn, tinf.BatchingConfig(
        max_batch_size=8, max_delay_ms=20.0))
    with pytest.raises(RuntimeError, match="not started"):
        server.submit(np.ones(2))
    with server:
        a = server.submit(np.ones(2, np.float32))
        b = server.submit(np.ones(4, np.float32))
        c = server.submit(np.ones(3, np.float32))
        ya, sa = a.result(timeout=10)
        yb, sb = b.result(timeout=10)
        with pytest.raises(ValueError, match="bad width"):
            c.result(timeout=10)
        y = server.infer(np.full(2, 3.0, np.float32))
    np.testing.assert_array_equal(ya, [2.0, 2.0])
    assert sb == 4.0 and y[1] == 6.0

    from paddle_tpu_torch import jit as tjit

    _, tm = mlps
    tjit.save(tm, str(tmp_path / "mlp"),
              input_spec=[tjit.InputSpec([4, 8], "float32")])
    cfg = tinf.Config(str(tmp_path / "mlp"))
    cfg.disable_gpu()
    served = tinf.InferenceServer(tinf.create_predictor(cfg))
    assert served.batching.buckets == [4]
    x8 = np.random.default_rng(5).standard_normal(8).astype(np.float32)
    with served:
        (row,) = served.infer(x8)
    assert served.stats["rows_padded"] == 3
    with torch.no_grad():
        np.testing.assert_allclose(row, tm(torch.from_numpy(x8)[None])[0],
                                   rtol=1e-6, atol=1e-6)
    with pytest.raises(TypeError):
        tinf.InferenceServer(42)


def test_bf16_module_outputs_come_back_as_f32(mlps):
    """A module with bf16 outputs: the rows reach the client as f32
    arrays (numpy has no bfloat16), equal to the module's own forward."""
    _, tm = mlps

    class Half(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = tnn.Linear(8, 4, device="cpu", dtype=torch.bfloat16)
            with torch.no_grad():
                self.lin.weight.copy_(tm[0].weight[:, :4])
                self.lin.bias.copy_(tm[0].bias[:4])

        def forward(self, x):
            return self.lin(x.bfloat16())

    m16 = Half()
    x = np.random.default_rng(3).standard_normal(8).astype(np.float32)
    with tinf.InferenceServer(m16) as server:
        (out,) = server.infer(x)
    assert out.dtype == np.float32 and out.shape == (4,)
    with torch.inference_mode():
        own = m16(torch.from_numpy(x)[None]).float().numpy()[0]
    np.testing.assert_array_equal(out, own)
