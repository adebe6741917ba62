"""The rest of paddle.distributed's small surface (counterpart of
paddle_tpu/distributed/api_extra.py, its tensor-parallel and gloo
parts): `ParallelMode`, the Megatron op-level `split`, `spawn`,
`destroy_process_group` and the gloo facade. The parameter server's
dataset facades and sparse-entry configs are ROADMAP A12.
"""
import os

import torch

__all__ = ["ParallelMode", "spawn", "split", "destroy_process_group",
           "gloo_init_parallel_env", "gloo_barrier", "gloo_release"]


class ParallelMode:
    """Hybrid-parallel mode ids (paddle's ParallelMode)."""

    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Run `func(*args)` in `nprocs` processes under the launcher's env
    contract (PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM / PADDLE_MASTER /
    PADDLE_LOCAL_RANK / PADDLE_LOCAL_SIZE; rank 0 hosts the store at
    PADDLE_MASTER). Each worker calls `init_parallel_env` itself. With
    `join` waits for them all and raises if one failed; else returns the
    processes. `func` must be picklable (a module-level function)."""
    import multiprocessing as mp
    import socket

    if nprocs == -1:
        nprocs = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    if nprocs <= 1:
        func(*args)
        return None
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        master = f"127.0.0.1:{s.getsockname()[1]}"
    ctx = mp.get_context("spawn")
    procs = []
    for rank in range(nprocs):
        env = {
            "PADDLE_MASTER": master,
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(nprocs),
            "PADDLE_LOCAL_RANK": str(rank),
            "PADDLE_LOCAL_SIZE": str(nprocs),
        }
        p = ctx.Process(target=_spawn_entry, args=(func, args, env),
                        daemon=daemon)
        p.start()
        procs.append(p)
    if not join:
        return procs
    for p in procs:
        p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"spawn workers failed with codes {bad}")
    return None


def _spawn_entry(func, args, env):
    os.environ.pop("PADDLE_MASTER_HOSTED", None)
    os.environ.update(env)
    func(*args)


def _init_like(shape, gen):
    return torch.empty(shape).normal_(0.0, 0.02, generator=gen)


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """Megatron single-op model parallelism: build the matching
    tensor-parallel layer over the mp axis (this rank's shard of a whole
    weight drawn from `core.rng`'s stream, so every rank cuts the same
    weight) and apply it to `x`. linear, axis=1: column-parallel
    (`gather_out` all-gathers); axis=0: row-parallel (`gather_out=False`
    takes `x` as already split). embedding: vocab-parallel."""
    from ..core import rng
    from .fleet.meta_parallel import mp_layers as mpu

    kw = {"device": x.device}
    gen = rng.next_generator("cpu")
    if operation == "linear":
        in_f, out_f = size
        has_bias = bias_attr is not False
        if axis == 1:
            layer = mpu.ColumnParallelLinear(
                in_f, out_f, has_bias=has_bias, gather_output=gather_out,
                **kw)
        else:
            layer = mpu.RowParallelLinear(
                in_f, out_f, has_bias=has_bias,
                input_is_parallel=not gather_out, **kw)
        mpu.load_full(layer, _init_like((in_f, out_f), gen),
                      torch.zeros(out_f) if has_bias else None)
        return layer(x)
    if operation == "embedding":
        vocab, dim = size
        layer = mpu.VocabParallelEmbedding(vocab, dim, **kw)
        mpu.load_full(layer, _init_like((vocab, dim), gen))
        return layer(x)
    raise ValueError(f"unsupported split operation {operation!r}")


def destroy_process_group(group=None):
    """Forget a group (every group with None), as the reference does."""
    from . import collective

    if group is None:
        collective._groups.clear()
        return
    collective._groups.pop(getattr(group, "id", group), None)


def gloo_init_parallel_env(rank_id, rank_num, server_endpoint):
    """The CPU rendezvous: the env contract from the arguments (unless
    already set), then the store at `server_endpoint` and the gloo
    process group over it (`env.ensure_multihost_initialized`; rank 0
    hosts the store)."""
    from . import env as env_mod

    os.environ.setdefault("PADDLE_TRAINER_ID", str(rank_id))
    os.environ.setdefault("PADDLE_TRAINERS_NUM", str(rank_num))
    os.environ.setdefault("PADDLE_MASTER", server_endpoint)
    env_mod.ensure_multihost_initialized()


def gloo_barrier():
    """A barrier over every process (nothing in one process)."""
    from . import xproc

    if xproc.is_multiprocess():
        xproc.barrier()


def gloo_release():
    """Nothing to free: the gloo group lives as long as the process, as
    the reference's coordination service does."""
