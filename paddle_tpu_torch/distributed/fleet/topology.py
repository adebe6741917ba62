"""Hybrid-parallel process topology (counterpart of
paddle_tpu/distributed/fleet/topology.py).

`CommunicateTopology` is the reference's N-D rank grid. The
`HybridCommunicateGroup` lays the process world out as the global mesh
(distributed/mesh.py) and builds one group per mesh axis; each axis's
comm lists become gloo subgroups, created once on every rank in the same
order (`collective.new_group`). Its per-rank ids are this process's mesh
coordinates.
"""
import itertools

import numpy as np

from .. import collective as coll
from .. import mesh as mesh_mod

__all__ = ["CommunicateTopology", "HybridCommunicateGroup"]


class CommunicateTopology:
    def __init__(self, hybrid_group_names=("data", "pipe", "sharding",
                                           "model"),
                 dims=(1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self._world_size = int(np.prod(self._dims))
        self._coord_of = {}
        self._rank_of = {}
        for rank, coord in enumerate(itertools.product(
                *[range(d) for d in self._dims])):
            self._coord_of[rank] = coord
            self._rank_of[coord] = rank

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world_size

    def get_rank(self, **kwargs):
        coord = tuple(kwargs[n] for n in self._parallel_names)
        return self._rank_of[coord]

    def get_coord(self, rank):
        return self._coord_of[rank]

    def get_axis_list(self, axis_name, index):
        axis = self._parallel_names.index(axis_name)
        return [r for r, c in self._coord_of.items() if c[axis] == index]

    def get_comm_list(self, axis_name):
        """All rank-groups along `axis_name` (one gloo subgroup each)."""
        axis = self._parallel_names.index(axis_name)
        other = [n for i, n in enumerate(self._parallel_names) if i != axis]
        groups = []
        for fixed in itertools.product(
                *[range(self.get_dim(n)) for n in other]):
            ranks = []
            for i in range(self._dims[axis]):
                kw = dict(zip(other, fixed))
                kw[self._parallel_names[axis]] = i
                ranks.append(self.get_rank(**kw))
            groups.append(ranks)
        return groups

    def get_rank_from_stage(self, global_rank, **kwargs):
        coord = list(self.get_coord(global_rank))
        for k, v in kwargs.items():
            coord[self._parallel_names.index(k)] = v
        return self._rank_of[tuple(coord)]


# reference axis name → mesh axis name
_MESH_AXIS = {"data": "dp", "pipe": "pp", "sharding": "sharding",
              "model": "mp", "sep": "sp", "expert": "ep"}


class HybridCommunicateGroup:
    """(reference topology.py:134.) One group per mesh axis; the check
    group spans dp, pp, sharding and mp."""

    def __init__(self, topology=None, dp_degree=None, mp_degree=None,
                 pp_degree=None, sharding_degree=None, sp_degree=1,
                 ep_degree=1):
        if topology is not None:
            dims = {n: topology.get_dim(n)
                    for n in topology.get_hybrid_group_names()}
            dp_degree = dims.get("data", 1)
            pp_degree = dims.get("pipe", 1)
            sharding_degree = dims.get("sharding", 1)
            mp_degree = dims.get("model", 1)
            sp_degree = dims.get("sep", 1)
        self._dp_degree = dp_degree or 1
        self._mp_degree = mp_degree or 1
        self._pp_degree = pp_degree or 1
        self._sharding_degree = sharding_degree or 1
        self._sp_degree = sp_degree or 1
        self._ep_degree = ep_degree or 1
        self._topo = topology or CommunicateTopology(
            ("data", "pipe", "sharding", "model"),
            (self._dp_degree, self._pp_degree, self._sharding_degree,
             self._mp_degree))
        if not mesh_mod.has_mesh():
            mesh_mod.init_mesh(
                dp=self._dp_degree, pp=self._pp_degree,
                sharding=self._sharding_degree, mp=self._mp_degree,
                sp=self._sp_degree, ep=self._ep_degree)
        self._dp_group = coll.new_group(axes=("dp",))
        self._mp_group = coll.new_group(axes=("mp",))
        self._pp_group = coll.new_group(axes=("pp",))
        self._sharding_group = coll.new_group(axes=("sharding",))
        self._sp_group = coll.new_group(axes=("sp",))
        self._ep_group = coll.new_group(axes=("ep",))
        self._check_group = coll.new_group(
            axes=("dp", "pp", "sharding", "mp"))

    @property
    def global_rank(self):
        from .. import env

        return env.get_rank()

    @property
    def nranks(self):
        return (self._dp_degree * self._mp_degree * self._pp_degree *
                self._sharding_degree * self._sp_degree * self._ep_degree)

    def get_parallel_mode(self):
        if self._pp_degree > 1:
            return "pipeline"
        if self._sharding_degree > 1:
            return "sharding"
        if self._mp_degree > 1:
            return "model"
        return "data"

    def _coord(self, axis):
        return mesh_mod.axis_index(axis)

    # ---- degrees / ids ----
    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sep_parallel_world_size(self):
        return self._sp_degree

    def get_expert_parallel_world_size(self):
        return self._ep_degree

    def get_data_parallel_rank(self):
        return self._coord("dp")

    def get_model_parallel_rank(self):
        return self._coord("mp")

    def get_stage_id(self):
        return self._coord("pp")

    def get_sharding_parallel_rank(self):
        return self._coord("sharding")

    # ---- groups ----
    def get_data_parallel_group(self):
        return self._dp_group

    def get_model_parallel_group(self):
        return self._mp_group

    def get_pipe_parallel_group(self):
        return self._pp_group

    def get_sharding_parallel_group(self):
        return self._sharding_group

    def get_sep_parallel_group(self):
        return self._sp_group

    def get_expert_parallel_group(self):
        return self._ep_group

    def get_check_parallel_group(self, *a, **k):
        return self._check_group

    def _src_rank(self, axis):
        """The global rank at position 0 of this rank's `axis` group."""
        from .. import env

        return mesh_mod.global_mesh().group_ranks((axis,),
                                                  env.get_rank())[0]

    def get_data_parallel_group_src_rank(self):
        return self._src_rank("dp")

    def get_model_parallel_group_src_rank(self):
        return self._src_rank("mp")

    def get_p2p_groups(self):
        return (self._pp_group, self._pp_group)

    def get_rank_from_stage(self, stage_id, **kwargs):
        return self._topo.get_rank_from_stage(self.global_rank,
                                              pipe=stage_id, **kwargs)

    # pipeline helpers
    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self._pp_degree - 1

    @property
    def topology(self):
        return self._topo
