"""The deployment predictor: the PyTorch port's inference `Config` /
`Predictor` / handles / `PredictorPool` / `convert_to_mixed_precision`,
and `InferenceServer` over a predictor loaded from disk, against the
JAX package's predictor on the same weights (`convert`), on CPU.
Mirrors tests/test_inference.py."""
import threading
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import inference as jinf
from paddle_tpu import jit as jjit
from paddle_tpu import nn as jnn
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch import jit as tjit
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


class _JTwo(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = jnn.Linear(8, 4)

    def forward(self, a, b):
        return self.fc(a + b)


class _TTwo(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = tnn.Linear(8, 4)

    def forward(self, a, b):
        return self.fc(a + b)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """{kind: (reference prefix, port prefix)} for a 1-input MLP saved at
    batch 4 and a 2-input layer, the same weights in both packages."""
    d = tmp_path_factory.mktemp("inf")
    paddle.seed(0)
    jm = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    tm = tnn.Sequential(tnn.Linear(8, 16), tnn.ReLU(), tnn.Linear(16, 4))
    j2, t2 = _JTwo(), _TTwo()
    out = {}
    for kind, (j, t, n_in) in {"mlp": (jm, tm, 1),
                                "two": (j2, t2, 2)}.items():
        load_jax_state_dict(t, {k: np.asarray(v.numpy())
                                for k, v in j.state_dict().items()})
        jjit.save(j, str(d / f"j{kind}"),
                  input_spec=[jjit.InputSpec([4, 8], "float32")] * n_in)
        tjit.save(t, str(d / f"t{kind}"),
                  input_spec=[tjit.InputSpec([4, 8], "float32")] * n_in)
        out[kind] = (str(d / f"j{kind}"), str(d / f"t{kind}"), t)
    return out


def _cpu_config(prefix):
    cfg = tinf.Config(prefix)
    cfg.disable_gpu()
    return cfg


def test_handle_io_matches_reference_predictor(artifacts):
    jp, tp, _ = artifacts["mlp"]
    x = np.random.default_rng(0).standard_normal((4, 8)).astype(np.float32)
    ref = jinf.create_predictor(jinf.Config(jp))
    pred = tinf.create_predictor(_cpu_config(tp))
    assert pred.get_input_names() == ref.get_input_names() == ["x0"]
    for p in (ref, pred):
        p.get_input_handle("x0").copy_from_cpu(x)
        p.run()
    got = pred.get_output_handle("output_0").copy_to_cpu()
    want = ref.get_output_handle("output_0").copy_to_cpu()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert pred.get_output_names() == ["output_0"]


def test_multi_input_direct_run(artifacts):
    jp, tp, _ = artifacts["two"]
    rng = np.random.default_rng(1)
    a, b = (rng.standard_normal((4, 8)).astype(np.float32) for _ in "ab")
    pred = tinf.create_predictor(_cpu_config(tp))
    assert pred.get_input_names() == ["x0", "x1"]
    (got,) = pred.run([a, b])
    (want,) = jinf.create_predictor(jinf.Config(jp)).run([a, b])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_default_config_is_the_card():
    cfg = tinf.Config("m")
    assert cfg.use_gpu() and cfg.gpu_device_id() == 0
    cfg.enable_use_gpu(100, 3)
    assert cfg.gpu_device_id() == 3
    cfg.disable_gpu()
    assert not cfg.use_gpu()
    assert "device=cpu" in cfg.summary()
    cfg.set_xla_compile_option("xla_cpu_enable_fast_math", True)
    assert cfg.xla_compile_options() == {"xla_cpu_enable_fast_math": True}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="GPU"):
            tinf.create_predictor(tinf.Config("m"))


def test_precision_mismatch_warns_and_runs_as_exported(artifacts):
    _, tp, tm = artifacts["mlp"]
    cfg = _cpu_config(tp)
    cfg.enable_mixed_precision(tinf.PrecisionType.Bfloat16)
    with pytest.warns(RuntimeWarning, match="exported"):
        pred = tinf.create_predictor(cfg)
    x = np.ones((4, 8), np.float32)
    (out,) = pred.run([x])
    with torch.no_grad():
        np.testing.assert_allclose(out, tm(torch.from_numpy(x)).numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_pool_shares_program_and_weights(artifacts):
    _, tp, _ = artifacts["mlp"]
    pool = tinf.PredictorPool(_cpu_config(tp), size=2)
    a, b = pool.retrieve(0), pool.retrieve(1)
    assert a._layer is b._layer
    assert [p.data_ptr() for p in a._layer._param_vals] == \
        [p.data_ptr() for p in b._layer._param_vals]
    assert a.get_input_handle("x0") is not b.get_input_handle("x0")
    x = np.ones((4, 8), np.float32)
    np.testing.assert_array_equal(a.run([x])[0], b.run([x])[0])


def test_convert_to_mixed_precision_matches_reference(artifacts, tmp_path):
    jp, tp, _ = artifacts["mlp"]
    jinf.convert_to_mixed_precision(jp, str(tmp_path / "j16"))
    tinf.convert_to_mixed_precision(tp, str(tmp_path / "t16"))
    from paddle_tpu_torch.framework.io_state import load as tload

    bundle = tload(str(tmp_path / "t16.pdiparams"), return_numpy=True)
    assert set(bundle["dtypes"]) == {"bfloat16"}
    assert all(a.dtype == np.uint16 for a in bundle["params"])
    x = np.random.default_rng(2).standard_normal((4, 8)).astype(np.float32)
    (got,) = tinf.create_predictor(_cpu_config(str(tmp_path / "t16"))
                                   ).run([x])
    (want,) = jinf.create_predictor(jinf.Config(str(tmp_path / "j16"))
                                    ).run([x])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError, match="calibration"):
        tinf.convert_to_mixed_precision(tp, str(tmp_path / "i8"),
                                        tinf.PrecisionType.Int8)


def test_bf16_outputs_copy_out_as_f32(tmp_path):
    class Half(tnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = tnn.Linear(8, 4, dtype="bfloat16")

        def forward(self, x):
            return self.fc(x.to(torch.bfloat16))

    m = Half()
    tjit.save(m, str(tmp_path / "h"),
              input_spec=[tjit.InputSpec([2, 8], "float32")])
    x = np.ones((2, 8), np.float32)
    (out,) = tinf.create_predictor(_cpu_config(str(tmp_path / "h"))).run([x])
    assert out.dtype == np.float32
    with torch.no_grad():
        np.testing.assert_array_equal(out, m(torch.from_numpy(x)).float())


def test_server_pads_every_batch_to_the_exported_batch(artifacts):
    """A predictor loaded from disk behind `InferenceServer`: the only
    bucket is the exported batch size (4), every row equals the same
    row of a direct run, and requests batch."""
    _, tp, tm = artifacts["mlp"]
    pred = tinf.create_predictor(_cpu_config(tp))
    xs = np.random.default_rng(3).standard_normal((24, 8)).astype(
        np.float32)
    server = tinf.InferenceServer(pred, tinf.BatchingConfig(
        max_batch_size=16, max_delay_ms=20.0))
    assert server.batching.buckets == [4]
    assert server.batching.max_batch_size == 4
    results, lock = {}, threading.Lock()

    def client(lo):
        futs = [(i, server.submit(xs[i])) for i in range(lo, lo + 8)]
        for i, f in futs:
            with lock:
                results[i] = f.result(timeout=60)[0]

    with server:
        threads = [threading.Thread(target=client, args=(k * 8,))
                   for k in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    with torch.no_grad():
        want = tm(torch.from_numpy(xs)).numpy()
    for i in range(24):
        np.testing.assert_allclose(results[i], want[i], rtol=1e-6,
                                   atol=1e-6)
    assert server.stats["batches"] < 24
    assert server.stats["requests"] == 24


def test_enums_and_helpers():
    assert tinf.get_num_bytes_of_data_type("bfloat16") == 2
    assert tinf.get_num_bytes_of_data_type(tinf.DataType.INT64) == 8
    assert tinf.PrecisionType.Bfloat16 == jinf.PrecisionType.Bfloat16
    assert tinf.PlaceType.GPU == "gpu"
    assert isinstance(tinf.get_version(), str)
    h = tinf.InferTensor("x0")
    h.reshape([2, 3])
    assert h.shape() == [2, 3]
    buf = np.ones(3)
    h.copy_from_cpu(buf)
    buf[0] = 5
    assert h.copy_to_cpu()[0] == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for name in jinf.__all__:
            assert hasattr(tinf, name), name
