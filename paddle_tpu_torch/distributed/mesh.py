"""The global process mesh (counterpart of paddle_tpu/distributed/mesh.py).

The reference lays its devices out as one `jax.sharding.Mesh`. The port
runs one process per mesh position, so the mesh is the process world
laid out in the same axis order — ``dp, pp, sharding, mp, sp, ep`` —
row-major: rank r sits at ``np.unravel_index(r, shape)``. A group along
some axes is the set of ranks that share every other coordinate, in
row-major order over those axes (the reference's flattened position
along a group's axes). Axes of size 1 are kept, so specs stay uniform.
"""
import numpy as np

__all__ = [
    "init_mesh", "global_mesh", "has_mesh", "axis_size", "mesh_axes",
    "PartitionSpec", "reset_mesh", "ProcessMesh", "coord", "axis_index",
]

_AXIS_ORDER = ("dp", "pp", "sharding", "mp", "sp", "ep")

_mesh = None


class PartitionSpec(tuple):
    """Per dimension: None (whole), an axis name, or a tuple of axis
    names (the dimension split over their flattened product), as the
    reference's `jax.sharding.PartitionSpec`."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


class ProcessMesh:
    """The process world as an N-D grid over `_AXIS_ORDER`."""

    axis_names = _AXIS_ORDER

    def __init__(self, sizes):
        self.shape = {a: int(sizes[a]) for a in _AXIS_ORDER}
        self.dims = tuple(self.shape[a] for a in _AXIS_ORDER)
        self.size = int(np.prod(self.dims))

    def coord(self, rank):
        """{axis: index} of `rank`."""
        return dict(zip(_AXIS_ORDER,
                        (int(i) for i in np.unravel_index(rank, self.dims))))

    def rank_of(self, coord):
        return int(np.ravel_multi_index(
            tuple(coord[a] for a in _AXIS_ORDER), self.dims))

    def position(self, axes, rank):
        """`rank`'s flattened position along `axes` (row-major, in the
        order given)."""
        c = self.coord(rank)
        pos = 0
        for a in axes:
            pos = pos * self.shape[a] + c[a]
        return pos

    def group_ranks(self, axes, rank):
        """The ranks of `rank`'s group along `axes`, by position."""
        base = self.coord(rank)
        out = []
        for idx in np.ndindex(*[self.shape[a] for a in axes]):
            c = dict(base)
            c.update(zip(axes, (int(i) for i in idx)))
            out.append(self.rank_of(c))
        return out

    def partition(self, axes):
        """Every group along `axes`, each by position, ordered by their
        first rank: the world cut into disjoint groups."""
        seen, out = set(), []
        for r in range(self.size):
            if r in seen:
                continue
            g = self.group_ranks(axes, r)
            seen.update(g)
            out.append(g)
        return out

    def __repr__(self):
        return f"ProcessMesh({self.shape})"


def _world_size():
    from . import env

    return env.get_world_size()


def init_mesh(dp=1, pp=1, sharding=1, mp=1, sp=1, ep=1, world_size=None):
    """Lay the process world out as the mesh. The product of the axis
    sizes must equal the world size (the reference's device count)."""
    global _mesh
    sizes = {"dp": dp, "pp": pp, "sharding": sharding, "mp": mp, "sp": sp,
             "ep": ep}
    have = _world_size() if world_size is None else int(world_size)
    need = int(np.prod(list(sizes.values())))
    if have != need:
        raise ValueError(f"mesh {sizes} needs {need} processes, have {have}")
    _mesh = ProcessMesh(sizes)
    return _mesh


def reset_mesh():
    global _mesh
    _mesh = None


def global_mesh():
    """The mesh; without `init_mesh`, the world as the dp axis."""
    if _mesh is None:
        return ProcessMesh({"dp": _world_size(), "pp": 1, "sharding": 1,
                            "mp": 1, "sp": 1, "ep": 1})
    return _mesh


def has_mesh():
    return _mesh is not None


def mesh_axes():
    return _AXIS_ORDER


def axis_size(axis):
    return global_mesh().shape[axis]


def coord(rank=None):
    """This process's (or `rank`'s) {axis: index}."""
    from . import env

    return global_mesh().coord(env.get_rank() if rank is None else rank)


def axis_index(axis, rank=None):
    return coord(rank)[axis]
