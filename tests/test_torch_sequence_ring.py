"""The ring and Ulysses attention (paddle_tpu_torch/distributed/
sequence_parallel.py) against the JAX package's.

As gloo processes under the port's launcher (tests/torch_hybrid_worker.py
`ring`): `ring_attention`, `ring_flash_attention` (the plain kernels on
the CPU) and `ulysses_attention` at sp 4 and sp 2, causal and full: each
rank's output shard and its q / k / v gradients of a probe loss against
the reference's functions on its own sp mesh (shard_map, Pallas in
interpret mode), 1e-5; the Ulysses heads check raises the reference's
ValueError; the sep group of the topology is the ring's group; the
causal ring skips the blocks above the diagonal. (Split from
tests/test_torch_sequence_parallel.py so the two run on two workers.)
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu_torch.distributed import mesh as tmesh

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


TOL = 1e-5
B, S, H, D = 2, 32, 4, 8


@pytest.fixture(autouse=True)
def _reset():
    tmesh.reset_mesh()
    yield
    tmesh.reset_mesh()
    jmesh.reset_mesh()


def _ring_inputs():
    rng = np.random.default_rng(21)
    return {n: rng.standard_normal((B, S, H, D)).astype(np.float32)
            for n in ("q", "k", "v", "w")}


def _reference_ring(a, sp, fn, causal):
    """(out, dq, dk, dv) of the reference's `fn` on its sp mesh."""
    jmesh.reset_mesh()
    jmesh.init_mesh(devices=jax.devices()[:sp], sp=sp)
    f = jdist.spmd(lambda q, k, v: getattr(jdist, fn)(q, k, v,
                                                      causal=causal),
                   in_specs=(JP(None, "sp"),) * 3, out_specs=JP(None, "sp"),
                   group_axes=("sp",))
    w = jnp.asarray(a["w"])

    @jax.jit
    def out_and_grads(q, k, v):
        out, vjp = jax.vjp(f, q, k, v)
        return (out,) + vjp(w)

    with jax.default_matmul_precision("highest"):
        got = out_and_grads(*(jnp.asarray(a[n]) for n in ("q", "k", "v")))
    jmesh.reset_mesh()
    return [np.asarray(g) for g in got]


@pytest.fixture(scope="module")
def ring_job(tmp_path_factory):
    from test_torch_mp_layers import launch_worker

    out = tmp_path_factory.mktemp("ring")
    a = _ring_inputs()
    np.savez(out / "ring_inputs.npz", **a)
    launch_worker("ring", out, 4, timeout=240)
    arrays = [dict(np.load(out / f"ring_r{r}.npz")) for r in range(4)]
    meta = [json.load(open(out / f"ring_r{r}.json")) for r in range(4)]
    return a, arrays, meta


@pytest.mark.parametrize("fn", worker.RING_FNS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("run", [name for name, _ in worker.RING_RUNS])
def test_ring_matches_reference(ring_job, run, causal, fn):
    a, arrays, meta = ring_job
    sp = dict(worker.RING_RUNS)[run]["sp"]
    want = _reference_ring(a, sp, fn, causal)
    s_loc = S // sp
    for rank in range(4):
        idx = meta[rank][run]["idx"]
        cols = slice(idx * s_loc, (idx + 1) * s_loc)
        key = f"{run}/{fn}/{int(causal)}"
        for name, w in zip(("out", "dq", "dk", "dv"), want):
            np.testing.assert_allclose(arrays[rank][f"{key}/{name}"],
                                       w[:, cols], rtol=TOL, atol=TOL,
                                       err_msg=f"rank {rank} {key}/{name}")


@pytest.mark.parametrize("run", [name for name, _ in worker.RING_RUNS])
def test_ring_blocks_heads_check_and_sep_group(ring_job, run):
    """Per rank and forward: 2 calls each of the dense and the flash ring
    (full, causal); the causal ring runs its diagonal block causal, the
    blocks below it full and skips the ones above; Ulysses' heads check
    is the reference's message; the sep group is the ring's group."""
    _, _, meta = ring_job
    sp = dict(worker.RING_RUNS)[run]["sp"]
    for rank in range(4):
        m = meta[rank][run]
        idx, st = m["idx"], m["stats"]
        # two ring functions x (full + causal): full sees sp full blocks
        assert st["causal"]["calls"] == 2
        assert st["full"]["calls"] == 2 * (sp + idx)
        assert st.get("skipped", {}).get("calls", 0) == 2 * (sp - 1 - idx)
        # K/V frames: sp - 1 forward, sp - 1 backward per call
        assert st["ring_p2p"]["calls"] == 4 * 2 * (sp - 1)
        assert m["ulysses_error"] == (f"heads {sp + 1} not divisible by "
                                      f"sp degree {sp}")
        sep = m["sep"]
        assert sep["axes"] == ["sp"] and sep["nranks"] == sp
        assert sep["rank"] == idx and sep["ring"][idx] == rank
