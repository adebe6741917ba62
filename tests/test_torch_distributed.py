"""The process mesh, the topology and the mesh-axis collectives
(paddle_tpu_torch/distributed/mesh.py, fleet/topology.py, collective.py,
communication/stream.py) against the JAX package's.

In one process: `CommunicateTopology`'s comm lists, ranks and coords
against the reference's; the `HybridCommunicateGroup`'s sizes, groups
and this rank's coordinates over a world given by the launcher's env
contract; `init_mesh` validation; the world-1 identities; the stream
variants' signatures.

One launched 4-process gloo battery (tests/torch_dist_worker.py
`collectives`, mesh dp 2 x mp 2): all_reduce (sum, max, avg),
all_gather, reduce_scatter, p2p_shift, alltoall, broadcast, reduce and
scatter over each axis group and over both axes, plus masked rank-subset
groups, each through the port's `spmd` on a global input — held against
the reference's `dist.spmd` on a 4-device CPU mesh over the same inputs.
Inputs are small integers in float32, so every reduction order is
exact: the tolerance is equality. Every rank returns the same global
value.
"""
import inspect
import os
import sys

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as paddle
from paddle_tpu import distributed as jdist
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed.communication import stream as jstream
from paddle_tpu.distributed.fleet.topology import \
    CommunicateTopology as JTopo
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.distributed.communication import stream as tstream
from paddle_tpu_torch.distributed.fleet import topology as ttopo

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as worker  # noqa: E402
from test_torch_parallel_step import launch  # noqa: E402

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


NAMES = ("data", "pipe", "sharding", "model")


@pytest.fixture(autouse=True)
def _reset():
    tmesh.reset_mesh()
    yield
    tmesh.reset_mesh()
    jmesh.reset_mesh()


@pytest.mark.parametrize("dims", [(2, 1, 1, 2), (2, 2, 1, 2), (1, 1, 4, 1),
                                  (3, 1, 2, 1)])
def test_topology_matches_reference(dims):
    t, j = ttopo.CommunicateTopology(NAMES, dims), JTopo(NAMES, dims)
    assert t.world_size() == j.world_size()
    for name in NAMES:
        assert t.get_comm_list(name) == j.get_comm_list(name)
        assert t.get_dim(name) == j.get_dim(name)
        for i in range(t.get_dim(name)):
            assert t.get_axis_list(name, i) == j.get_axis_list(name, i)
    for r in range(t.world_size()):
        assert t.get_coord(r) == j.get_coord(r)
        assert t.get_rank(**dict(zip(NAMES, t.get_coord(r)))) == r
        assert t.get_rank_from_stage(r, pipe=0) == \
            j.get_rank_from_stage(r, pipe=0)


@pytest.mark.parametrize("rank", [0, 5])
def test_hcg_over_the_process_world(monkeypatch, rank):
    """dp 2 x pp 2 x mp 2 over an 8-process world named by the env
    contract (no process group: groups carry no communicator here).
    The mesh groups each axis's ranks as the topology's comm lists do,
    and the HCG's per-rank ids are this rank's coordinates."""
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "8")
    monkeypatch.setenv("PADDLE_TRAINER_ID", str(rank))
    hcg = ttopo.HybridCommunicateGroup(dp_degree=2, mp_degree=2,
                                       pp_degree=2)
    assert hcg.nranks == 8 and hcg.get_parallel_mode() == "pipeline"
    assert (hcg.get_data_parallel_world_size(),
            hcg.get_model_parallel_world_size(),
            hcg.get_pipe_parallel_world_size(),
            hcg.get_sharding_parallel_world_size()) == (2, 2, 2, 1)
    coord = hcg.topology.get_coord(rank)
    assert (hcg.get_data_parallel_rank(), hcg.get_stage_id(),
            hcg.get_sharding_parallel_rank(),
            hcg.get_model_parallel_rank()) == coord
    mesh = tmesh.global_mesh()
    for axis, name in (("dp", "data"), ("pp", "pipe"), ("mp", "model")):
        assert mesh.partition((axis,)) == sorted(
            hcg.topology.get_comm_list(name))
        assert rank in mesh.group_ranks((axis,), rank)
    assert hcg.get_data_parallel_group().nranks == 2
    assert hcg.get_data_parallel_group().rank == coord[0]
    assert hcg.get_model_parallel_group_src_rank() == \
        mesh.group_ranks(("mp",), rank)[0]
    assert hcg.is_first_stage() == (coord[1] == 0)


def test_init_mesh_validates_against_the_world():
    with pytest.raises(ValueError, match="needs 4 processes, have 1"):
        tmesh.init_mesh(dp=2, mp=2)
    with pytest.raises(ValueError, match="needs 4 devices"):
        jmesh.init_mesh(dp=2, mp=2, devices=jax.devices()[:2])
    m = tmesh.init_mesh(dp=2, mp=2, world_size=4)
    assert tmesh.axis_size("mp") == 2 and tmesh.mesh_axes() == \
        jmesh.mesh_axes()
    assert [m.coord(r)["dp"] for r in range(4)] == [0, 0, 1, 1]
    assert m.group_ranks(("mp",), 2) == [2, 3]
    assert m.group_ranks(("mp", "dp"), 0) == [0, 2, 1, 3]


def test_world_one_identities():
    """A world of one: init_parallel_env lays out the 1-process mesh,
    every collective is the identity, axis groups have one rank, and
    spmd returns fn's value on the whole input."""
    g = tdist.init_parallel_env(device="cpu")
    assert (g.nranks, g.rank) == (1, 0)
    mp = tdist.new_group(axes=("mp",))
    assert (mp.nranks, mp.rank, mp.axes) == (1, 0, ("mp",))
    x = torch.arange(4.0)
    for call in (lambda: tdist.all_reduce(x, group=mp),
                 lambda: tdist.reduce_scatter(x, group=mp),
                 lambda: tdist.alltoall(x, group=mp),
                 lambda: tdist.p2p_shift(x, group=mp),
                 lambda: tdist.broadcast(x, src=0, group=mp),
                 lambda: tdist.reduce(x, dst=0, group=mp)):
        out = call()
        assert out is x and x.tolist() == [0.0, 1.0, 2.0, 3.0]
    assert tdist.all_gather(None, x, group=mp).tolist() == x.tolist()
    f = tdist.spmd(lambda v: tdist.all_reduce(v * 2), in_specs=tdist.
                   PartitionSpec("dp"), out_specs=tdist.PartitionSpec("dp"))
    assert f(x).tolist() == [0.0, 2.0, 4.0, 6.0]
    with pytest.raises(NotImplementedError, match="unequal split"):
        tdist.alltoall_single(x, in_split_sizes=[1, 3])
    with pytest.raises(ValueError, match="out of range"):
        tdist.new_group(ranks=[1], axes=("mp",))


def test_stream_variants_keep_the_reference_signatures():
    for name in jstream.__all__:
        t, j = getattr(tstream, name), getattr(jstream, name)
        assert list(inspect.signature(t).parameters) == \
            list(inspect.signature(j).parameters), name
    x = torch.ones(2)
    assert tstream.all_reduce(x, use_calc_stream=True) is x


# ---- the launched battery ---------------------------------------------

@pytest.fixture(scope="module")
def battery(tmp_path_factory):
    out = tmp_path_factory.mktemp("coll")
    rc, so, se = launch("collectives", out, 4)
    assert rc == 0, f"{so}\n{se}"
    return [dict(np.load(out / f"coll_r{r}.npz")) for r in range(4)]


def _reference(i, case):
    name, (axes, ranks), op, out_axes, shape = case
    jmesh.reset_mesh()
    jmesh.init_mesh(dp=2, mp=2, devices=jax.devices()[:4])
    try:
        g = jdist.new_group(ranks=ranks, axes=axes)
        P = jax.sharding.PartitionSpec
        f = jdist.spmd(lambda v: op(jdist, g, paddle.Tensor(v))._value,
                       in_specs=P(worker.IN_AXES), out_specs=P(out_axes))
        return np.asarray(f(jax.numpy.asarray(worker.case_input(i, shape))))
    finally:
        jmesh.reset_mesh()


# The reference's p2p_shift over a group of several axes permutes only
# as many positions as the FIRST axis has (`_shift`: n = axis_size(
# axes[0])), so the other positions receive zeros (ROADMAP §C). The port
# shifts the whole ring; this case is held to the ring shift itself.
RING_OVER_BOTH_AXES = "p2p_shift_dp_mp_back"


def _ring_shift_back(x):
    """Position i receives position (i + 1) mod 4's block of 2 rows."""
    return np.roll(x.reshape(4, 2, -1), -1, axis=0).reshape(x.shape)


@pytest.mark.parametrize("i", range(len(worker.COLLECTIVE_CASES)),
                         ids=[c[0] for c in worker.COLLECTIVE_CASES])
def test_collective_matches_reference_spmd(battery, i):
    case = worker.COLLECTIVE_CASES[i]
    want = _reference(i, case)
    if case[0] == RING_OVER_BOTH_AXES:
        x = worker.case_input(i, case[4])
        ring = _ring_shift_back(x)
        # the reference swaps positions 0 and 1 and zeroes 2 and 3
        np.testing.assert_array_equal(want[:2], x[2:4])
        np.testing.assert_array_equal(want[2:4], x[:2])
        assert not want[4:].any() and ring[4:].any()
        want = ring
    for r in range(4):
        got = battery[r][case[0]]
        assert got.shape == want.shape, (case[0], r)
        np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")


def test_eager_world_group_and_axis_group_ranks(battery):
    """Outside spmd the default group is the world (the eager path);
    an mp axis group's rank is this process's mp coordinate."""
    for r in range(4):
        np.testing.assert_array_equal(battery[r]["eager_world_all_reduce"],
                                      np.full(3, 10.0))
        np.testing.assert_array_equal(battery[r]["eager_world_all_gather"],
                                      np.arange(4.0))
        assert battery[r]["group_rank_nranks"].tolist() == [r % 2, 2]


def test_reduce_scatter_list_at_world_one():
    """A list input fills `tensor` in one process too (paddle's list
    semantics at every group size): the chunk of a group of one is the
    whole concatenated list. The reference ignores the list and returns
    `tensor` unchanged (ROADMAP §C, a quirk the port does not follow)."""
    out = torch.zeros(2)
    got = tdist.reduce_scatter(out, [torch.tensor([1.0, 2.0])])
    assert got is out and out.tolist() == [1.0, 2.0]
    out = torch.zeros(4)
    tdist.reduce_scatter(out, [torch.tensor([1.0, 2.0]),
                               torch.tensor([3.0, 4.0])],
                         group=tdist.new_group(axes=("mp",)))
    assert out.tolist() == [1.0, 2.0, 3.0, 4.0]
    x = torch.arange(4.0)
    assert tdist.reduce_scatter(x) is x and x.tolist() == [0, 1, 2, 3]


def test_reduce_scatter_list_across_ranks(battery):
    """The 4-process battery's list case over each mp group: every rank's
    two parts concatenated, summed over the group, and this rank's mp
    position's half written into `tensor` (and returned)."""
    for r in range(4):
        a, b = 2 * (r // 2), 2 * (r // 2) + 1
        whole = sum(torch.cat(worker.reduce_scatter_list(k)).numpy()
                    for k in (a, b))
        want = whole[2 * (r % 2):2 * (r % 2) + 2]
        got = battery[r]["reduce_scatter_list_mp"]
        np.testing.assert_array_equal(got[0], want)
        np.testing.assert_array_equal(got[1], want)
