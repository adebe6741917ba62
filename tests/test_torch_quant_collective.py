"""The block-scaled int8 gradient collectives
(paddle_tpu_torch/distributed/quant_collective.py), the eager int8 wire
(quantization/runtime.py, xproc) and the `quant_allreduce` knobs of the
train steps, against the JAX package's.

Launched gloo jobs of 2 and 4 processes (tests/torch_hybrid_worker.py
`quant`) run `quantized_pmean` over dp (and over dp x sharding at 4),
its NaN-poisoned case and `quantized_pmean_tree` (a big f32 leaf, a
bf16 leaf that joins the fused payload, a small leaf that takes the
exact mean): every rank's result is bit-equal to the reference's
`shard_map` on the same inputs (8 virtual CPU devices). The eager
avg all-reduce under PT_QUANT_ALLREDUCE=1 equals the reference's KV
path (the decoded frames' mean), max stays exact. At dp 2 and 4,
`DistributedTrainStep(quant_allreduce=True)` ends within the reference's
5 % of the exact serial step, with about a quarter of the f32 bytes;
`_validate_quant_path` raises the reference's ValueErrors.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

import paddle_tpu as paddle
from paddle_tpu import distributed as jdist
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed import quant_collective as jqc
from paddle_tpu.quantization import runtime as jrt
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.distributed import parallel_step as tps
from paddle_tpu_torch.distributed import quant_collective as tqc

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_hybrid_worker as worker  # noqa: E402

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


N_ELEM = 3000


@pytest.fixture(autouse=True)
def _reset():
    tmesh.reset_mesh()
    yield
    tmesh.reset_mesh()
    jmesh.reset_mesh()


def _inputs(n):
    rng = np.random.default_rng(10 + n)
    a = {}
    for r in range(n):
        x = (rng.standard_normal(N_ELEM) * (r + 1)).astype(np.float32)
        a[f"x_r{r}"] = x
        bad = x.copy()
        if r == 0:
            bad[700] = np.nan
        if r == n - 1:
            bad[2500] = np.inf
        a[f"nan_r{r}"] = bad
        a[f"w_r{r}"] = rng.standard_normal((40, 30)).astype(np.float32)
        a[f"b_r{r}"] = rng.standard_normal(30).astype(np.float32)
        a[f"m_r{r}"] = rng.standard_normal((8, 16)).astype(np.float32)
    a["net_w"] = (rng.standard_normal((128, 128)) * 0.05).astype(np.float32)
    a["net_b"] = np.zeros(128, np.float32)
    a["step_x"] = rng.standard_normal((32, 128)).astype(np.float32)
    a["step_y"] = rng.standard_normal((32, 128)).astype(np.float32)
    return a


@pytest.fixture(scope="module", params=[2, 4])
def job(request, tmp_path_factory):
    from test_torch_mp_layers import launch_worker

    n = request.param
    out = tmp_path_factory.mktemp(f"quant{n}")
    a = _inputs(n)
    np.savez(out / f"quant_inputs_{n}.npz", **a)
    launch_worker("quant", out, n, timeout=240)
    res = [dict(np.load(out / f"quant_r{r}.npz")) for r in range(n)]
    return n, a, res


def _reference(n, fn, stacked, case):
    """fn applied per device under the reference's shard_map, on rows
    stacked [n, ...] (dp) or [2, n/2, ...] (dp x sharding)."""
    if case == "dp":
        jmesh.init_mesh(dp=n, devices=jax.devices()[:n])
        spec = JP("dp")
        body = (lambda *xs: jax.tree_util.tree_map(
            lambda v: v[None], fn(*[x[0] for x in xs])))
    else:
        jmesh.init_mesh(dp=2, sharding=n // 2, devices=jax.devices()[:n])
        spec = JP("dp", "sharding")
        stacked = [s.reshape((2, n // 2) + s.shape[1:]) for s in stacked]
        body = (lambda *xs: jax.tree_util.tree_map(
            lambda v: v[None, None], fn(*[x[0, 0] for x in xs])))
    run = jax.jit(jax.shard_map(body, mesh=jmesh.global_mesh(),
                                in_specs=tuple(spec for _ in stacked),
                                out_specs=spec, check_vma=False))
    out = run(*[jnp.asarray(s) for s in stacked])
    jmesh.reset_mesh()
    return jax.tree_util.tree_map(
        lambda v: np.asarray(v.astype(jnp.float32)).reshape(
            (n,) + v.shape[(1 if case == "dp" else 2):]), out)


def _axes(case):
    return "dp" if case == "dp" else ("dp", "sharding")


def _cases(n):
    return ["dp"] + (["dp_sharding"] if n == 4 else [])


def test_quantized_pmean_bit_equal_to_reference(job):
    n, a, res = job
    for case in _cases(n):
        for key in ("x", "nan"):
            rows = np.stack([a[f"{key}_r{r}"] for r in range(n)])
            want = _reference(n, lambda x: jqc.quantized_pmean(
                x, _axes(case)), [rows], case)
            for r in range(n):
                np.testing.assert_array_equal(res[r][f"{case}/{key}"],
                                              want[r], err_msg=(case, key))
        # the poison: the NaN's and the inf's blocks decode to NaN on
        # every rank, the other blocks stay finite
        nan = np.isnan(res[0][f"{case}/nan"])
        blocks = {i // jqc.DEFAULT_BLOCK for i in np.nonzero(nan)[0]}
        assert blocks == {700 // 512, 2500 // 512}
        assert nan.sum() == 2 * jqc.DEFAULT_BLOCK
        # the exact mean within the reference's bound
        exact = np.mean([a[f"x_r{r}"] for r in range(n)], axis=0)
        assert np.abs(res[0][f"{case}/x"] - exact).max() <= 3.5 * max(
            np.abs(a[f"x_r{r}"]).max() for r in range(n)) / 127.0


def test_quantized_pmean_tree_bit_equal_to_reference(job):
    """One fused payload for the f32 and bf16 leaves (dtypes kept), the
    exact mean for the 30-element leaf."""
    n, a, res = job
    for case in _cases(n):
        stacked = [np.stack([a[f"{k}_r{r}"] for r in range(n)])
                   for k in ("w", "b", "m")]

        def fn(w, b, m):
            return jqc.quantized_pmean_tree(
                {"w": w, "b": b, "m": m.astype(jnp.bfloat16)}, _axes(case))

        want = _reference(n, fn, stacked, case)
        for r in range(n):
            for k in ("w", "b", "m"):
                np.testing.assert_array_equal(
                    res[r][f"{case}/tree_{k}"], want[k][r],
                    err_msg=(case, k))
            assert str(res[r][f"{case}/tree_m_dtype"]) == "torch.bfloat16"
            assert str(res[r][f"{case}/tree_w_dtype"]) == "torch.float32"


def test_eager_wire_all_reduce_matches_reference(job):
    """PT_QUANT_ALLREDUCE=1: avg over the world is the mean of every
    rank's decoded frame (the reference's KV path), max exact."""
    n, a, res = job
    rows = [a[f"x_r{r}"] for r in range(n)]
    dec = np.stack([jrt.decode_int8_wire(jrt.encode_int8_wire(x))
                    for x in rows])
    want = dec.mean(axis=0).astype(np.float32)
    for r in range(n):
        np.testing.assert_array_equal(res[r]["wire/avg"], want)
        np.testing.assert_array_equal(res[r]["wire/max"],
                                      np.max(rows, axis=0))


def test_quant_step_within_five_percent_of_exact(job):
    """dp 2 and dp 4: six SGD steps of DistributedTrainStep(
    quant_allreduce=True) end within 5 % of the exact serial run (the
    reference's bar), every rank alike; the bytes a rank puts into the
    exchange are under 0.3 of the f32 all-reduce's payload (a quarter,
    plus the block grid's padding on this 16.5k-element model)."""
    from paddle_tpu_torch.optimizer import SGD

    n, a, res = job
    net = worker.quant_net(a)
    opt = SGD(0.1, parameters=net.parameters())
    x, y = torch.from_numpy(a["step_x"]), torch.from_numpy(a["step_y"])
    exact = []
    for _ in range(6):
        loss = worker.quant_loss(net, x, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        exact.append(float(loss))
    for r in range(n):
        q = res[r]["step/losses"]
        np.testing.assert_array_equal(q, res[0]["step/losses"])
        assert abs(q[-1] - exact[-1]) <= 0.05 * abs(exact[-1]), (q, exact)
    f32 = (128 * 128 + 128 + 1) * 4
    assert int(res[0]["step/bytes"]) <= 0.3 * f32


def test_validate_quant_path_raises_the_reference_errors(monkeypatch):
    """ZeRO p_g_os, custom batch_specs and a mesh-sharded parameter: the
    reference's ValueErrors (at its first step; the port's at
    construction, where it validates its mesh)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel.mp_layers import (
        mark_sharding)
    from paddle_tpu_torch.distributed.mesh import PartitionSpec as TP
    from paddle_tpu_torch.optimizer import SGD

    jmesh.init_mesh(dp=8)
    x = paddle.to_tensor(np.zeros((8, 8), np.float32))
    want = {}
    for name, kw in (("p_g_os", dict(zero_level="p_g_os")),
                     ("batch_specs", dict(batch_specs=[JP("dp"),
                                                       JP("dp")]))):
        net = paddle.nn.Linear(8, 8)
        step = jdist.DistributedTrainStep(
            net, lambda m, a, b: ((m(a) - b) ** 2).mean(),
            paddle.optimizer.SGD(0.1, parameters=net.parameters()),
            quant_allreduce=True, **kw)
        with pytest.raises(ValueError) as e:
            step(x, x)
        want[name] = str(e.value)
    jmesh.reset_mesh()
    tmesh.init_mesh(dp=2, world_size=2)
    for name, kw in (("p_g_os", dict(zero_level="p_g_os")),
                     ("batch_specs", dict(batch_specs=[TP("dp"),
                                                       TP("dp")]))):
        net = torch.nn.Linear(8, 8)
        with pytest.raises(ValueError) as e:
            tps.DistributedTrainStep(net, None, SGD(
                0.1, parameters=net.parameters()), quant_allreduce=True,
                **kw)
        assert str(e.value) == want[name]
    net = torch.nn.Linear(8, 8)
    mark_sharding(net.weight, None, "mp")
    with pytest.raises(ValueError, match="mesh-sharded"):
        tps.DistributedTrainStep(net, None, SGD(
            0.1, parameters=net.parameters()), quant_allreduce=True)
    # the env knob opts in; at world 1 there is nothing to quantize
    monkeypatch.setenv("PT_QUANT_ALLREDUCE_XLA", "1")
    assert tqc.xla_quant_enabled() and jqc.xla_quant_enabled()
    tmesh.reset_mesh()
    step = tps.DistributedTrainStep(net, None, SGD(
        0.1, parameters=net.parameters()))
    assert step.quant_allreduce and step._quant_axes == ()
