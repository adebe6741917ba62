"""The rest of paddle.distributed's small surface (paddle_tpu_torch/
distributed/api_extra.py, parallel_with_gloo.py, cloud_utils.py) against
the JAX package's: `ParallelMode`, the signatures and exports, the
cluster layout from the env contract, `destroy_process_group`, and
`spawn` starting two processes under the launcher's env contract that
bring gloo up, all-reduce and pass the gloo barrier. The tensor-parallel
`split` is held against the reference in test_torch_mp_layers.py.
"""
import inspect
import json
import os
import sys

import pytest

from paddle_tpu.distributed import api_extra as japi
from paddle_tpu.distributed import cloud_utils as jcloud
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.distributed import api_extra as tapi
from paddle_tpu_torch.distributed import cloud_utils as tcloud
from paddle_tpu_torch.distributed import parallel_with_gloo as tgloo

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_hybrid_worker as worker  # noqa: E402

pytestmark = pytest.mark.torch_port

SURFACE = ("ParallelMode", "spawn", "split", "destroy_process_group",
           "gloo_init_parallel_env", "gloo_barrier", "gloo_release")


def test_surface_exported_with_the_reference_signatures():
    assert set(tapi.__all__) == set(SURFACE)
    assert set(SURFACE) <= set(japi.__all__)
    for name in SURFACE:
        assert getattr(tdist, name) is getattr(tapi, name)
        if name == "ParallelMode":
            continue
        assert list(inspect.signature(getattr(tapi, name)).parameters) == \
            list(inspect.signature(getattr(japi, name)).parameters), name
    for name in tgloo.__all__:
        assert getattr(tgloo, name) is getattr(tapi, name)


def test_parallel_mode_ids():
    for name in ("DATA_PARALLEL", "TENSOR_PARALLEL", "PIPELINE_PARALLEL",
                 "SHARDING_PARALLEL"):
        assert getattr(tapi.ParallelMode, name) == \
            getattr(japi.ParallelMode, name)


@pytest.mark.parametrize("env,args", [
    ({"PADDLE_TRAINER_ENDPOINTS": "10.0.0.1:8000,10.0.0.2:8000",
      "PADDLE_TRAINERS_NUM": "2"}, {}),
    ({"PADDLE_TRAINER_ENDPOINTS": "10.0.0.1:1,10.0.0.10:2,10.0.0.1:3"},
     {}),
    ({}, {"args_node_ips": "1.2.3.4,5.6.7.8", "args_port": 99}),
    ({"POD_IP": "5.6.7.8"}, {"args_node_ips": "1.2.3.4,5.6.7.8"}),
])
def test_cloud_cluster_matches_reference(monkeypatch, env, args):
    for k in ("PADDLE_TRAINER_ENDPOINTS", "PADDLE_TRAINERS_NUM", "POD_IP"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tcloud.get_cloud_cluster(**args) == \
        jcloud.get_cloud_cluster(**args)
    assert tcloud.get_trainers_num() == jcloud.get_trainers_num()


def test_destroy_process_group_forgets_groups():
    from paddle_tpu_torch.distributed import collective

    g = tdist.new_group(axes=("mp",))
    assert collective._groups.get(g.id) is g
    tdist.destroy_process_group(g)
    assert g.id not in collective._groups
    tdist.new_group(axes=("dp",))
    tdist.destroy_process_group()
    assert collective._groups == {}


def test_one_process_facade():
    """In one process: spawn(nprocs=1) calls the function here, and the
    gloo barrier and release do nothing."""
    seen = []
    assert tdist.spawn(seen.append, args=(7,), nprocs=1) is None
    assert seen == [7]
    tdist.gloo_barrier()
    tdist.gloo_release()


def test_spawn_two_processes_over_gloo(tmp_path, monkeypatch):
    """spawn(nprocs=2): each worker gets the env contract (rank, world,
    local rank, a master it rendezvouses at), brings gloo up, and their
    world all-reduce sums both ranks' values."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.delenv("PADDLE_MASTER_HOSTED", raising=False)
    tdist.spawn(worker.spawn_target, args=(str(tmp_path), 2.0), nprocs=2)
    outs = [json.load(open(tmp_path / f"spawn_r{r}.json"))
            for r in range(2)]
    assert [o["sum"] for o in outs] == [6.0, 6.0]
    assert [o["world"] for o in outs] == [2, 2]
    assert [o["local"] for o in outs] == ["0", "1"]
