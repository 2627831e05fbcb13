"""Mesh topology and the HybridCommunicateGroup (counterpart of
``paddle_tpu/distributed/mesh.py``).

The reference is one process driving every device: a ``jax.sharding.Mesh``
whose named axes (pp, dp, sharding, sep, ep, mp) stand for Paddle's
per-axis communicators, with XLA emitting the collectives. Here each rank
is a process (``parallel.init_parallel_env``), and the mesh is a
``torch.distributed`` ``DeviceMesh`` over the ranks with the same axis
names in the same order, ``mp`` innermost, so the tensor-parallel groups
are the ranks closest together (one host's NVLink). Each axis of the mesh
is a process sub-group (:meth:`HybridCommunicateGroup.group`).
"""
from __future__ import annotations

import math

import torch.distributed as dist

from .strategy import DistributedStrategy

__all__ = [
    "HybridCommunicateGroup", "build_mesh", "get_hybrid_communicate_group",
    "set_hybrid_communicate_group", "P", "current_mesh", "AXIS_ORDER",
    "mesh_shape",
]

_GLOBAL_HCG = None

# canonical axis order, outermost -> innermost
AXIS_ORDER = ("pp", "dp", "sharding", "sep", "ep", "mp")


class P(tuple):
    """A partition spec: per dim, ``None`` or the mesh axis (or axes) that
    shards it (``jax.sharding.PartitionSpec``'s shape, used for the
    checkpoint metadata and ``mark_sharding``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple(self)!r}"


def _degrees(strategy):
    h = (strategy or DistributedStrategy()).hybrid_configs
    return {"pp": h.pp_degree, "dp": h.dp_degree,
            "sharding": h.sharding_degree, "sep": h.sep_degree,
            "ep": h.ep_degree, "mp": h.mp_degree}


def build_mesh(strategy: DistributedStrategy | None = None, devices=None,
               degrees: dict | None = None, device=None):
    """The hybrid ``DeviceMesh`` from the strategy's degrees (or an explicit
    ``degrees`` dict; missing axes are 1). Its size must be the world
    size. With no process group yet and a mesh of one rank, this process
    becomes a world of one (``init_parallel_env``; ``device`` as there);
    a larger mesh needs ``init_parallel_env`` in every rank first."""
    from torch.distributed.device_mesh import init_device_mesh

    from .parallel import env_device, init_parallel_env

    if degrees is None:
        degrees = _degrees(strategy)
    unknown = set(degrees) - set(AXIS_ORDER)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; the axes "
                         f"are {AXIS_ORDER}")
    shape = tuple(int(degrees.get(a, 1)) for a in AXIS_ORDER)
    total = math.prod(shape)
    if not dist.is_initialized():
        if total != 1:
            raise RuntimeError(
                f"a mesh of {total} ranks needs init_parallel_env() in "
                f"each of them first (spawn or launch start the ranks)")
        init_parallel_env(device=device)
    world = dist.get_world_size()
    if total != world:
        raise ValueError(
            f"mesh needs {total} ranks ({dict(zip(AXIS_ORDER, shape))}), "
            f"the world has {world}")
    return init_device_mesh(env_device().type, shape,
                            mesh_dim_names=AXIS_ORDER)


def mesh_shape(mesh) -> dict:
    """``{axis: size}`` of a mesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


class HybridCommunicateGroup:
    """Rank bookkeeping over the mesh (Paddle's HybridCommunicateGroup):
    each axis's degree, this rank's coordinate on it, and its group."""

    def __init__(self, strategy: DistributedStrategy | None = None,
                 mesh=None):
        self.strategy = strategy or DistributedStrategy()
        self.mesh = mesh if mesh is not None else build_mesh(self.strategy)
        self._shape = mesh_shape(self.mesh)
        self._groups = {}
        self._make_data_group()

    # -- degrees ----------------------------------------------------------
    def get_data_parallel_world_size(self):
        return self._shape.get("dp", 1)

    def get_model_parallel_world_size(self):
        return self._shape.get("mp", 1)

    def get_pipe_parallel_world_size(self):
        return self._shape.get("pp", 1)

    def get_sharding_parallel_world_size(self):
        return self._shape.get("sharding", 1)

    def get_sep_parallel_world_size(self):
        return self._shape.get("sep", 1)

    def get_expert_parallel_world_size(self):
        return self._shape.get("ep", 1)

    @property
    def nranks(self):
        return math.prod(self._shape.values())

    # -- this rank's coordinates -------------------------------------------
    def _coord(self, axis):
        return int(self.mesh.get_local_rank(axis))

    def coords(self) -> dict:
        return {a: self._coord(a) for a in self.mesh.mesh_dim_names}

    def get_data_parallel_rank(self):
        return self._coord("dp")

    def get_model_parallel_rank(self):
        return self._coord("mp")

    def get_stage_id(self):
        return self._coord("pp")

    def get_sharding_parallel_rank(self):
        return self._coord("sharding")

    def get_sep_parallel_rank(self):
        return self._coord("sep")

    def get_expert_parallel_rank(self):
        return self._coord("ep")

    # -- groups (Paddle returns its communicators) -------------------------
    def group(self, axis):
        """The :class:`~.collective.Group` of ``axis``: the ranks that share
        every other coordinate with this one."""
        g = self._groups.get(axis)
        if g is None:
            from .collective import Group

            g = self._groups[axis] = Group(self.mesh.get_group(axis), axis)
        return g

    def get_data_parallel_group(self):
        return self.group("dp")

    def get_model_parallel_group(self):
        return self.group("mp")

    def get_pipe_parallel_group(self):
        return self.group("pp")

    def get_sharding_parallel_group(self):
        return self.group("sharding")

    def get_sep_parallel_group(self):
        return self.group("sep")

    def get_expert_parallel_group(self):
        return self.group("ep")

    def data_group(self):
        """The ranks that split the batch: dp x sharding (the reference's
        ``("dp", "sharding")`` batch axes), made when the HCG is."""
        return self._groups["data"]

    def _make_data_group(self):
        from .collective import Group

        n = self._shape["dp"] * self._shape["sharding"]
        if n == 1 or self.nranks == 1:
            # one rank splits the batch: the dp group is that group of one
            self._groups["data"] = Group(self.mesh.get_group("dp"), "data")
            return
        # every rank makes every sub-group, in the same order (new_group
        # is collective over the world)
        ranks = self.mesh.mesh.permute(0, 3, 4, 5, 1, 2).reshape(-1, n)
        me = dist.get_rank()
        for row in ranks.tolist():
            pg = dist.new_group(row)
            if me in row:
                self._groups["data"] = Group(pg, "data")

    def get_data_rank(self):
        return (self.get_data_parallel_rank()
                * self.get_sharding_parallel_world_size()
                + self.get_sharding_parallel_rank())

    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self.get_pipe_parallel_world_size() - 1

    def topology(self):
        return dict(self._shape)


def set_hybrid_communicate_group(hcg: HybridCommunicateGroup | None):
    global _GLOBAL_HCG
    _GLOBAL_HCG = hcg


def get_hybrid_communicate_group() -> HybridCommunicateGroup | None:
    return _GLOBAL_HCG


def current_mesh():
    hcg = get_hybrid_communicate_group()
    return hcg.mesh if hcg is not None else None
