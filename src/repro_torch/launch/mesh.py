"""Device meshes over ``torch.distributed`` (counterpart of
``repro.launch.mesh``).

A :class:`Mesh` wraps a ``DeviceMesh`` with the read-outs the sharding
code needs: ``shape`` (axis name -> size, as ``jax.sharding.Mesh.shape``),
``axis_names``, ``size``, this rank's ``coordinate()`` and the process
group along one axis.  ``ShardingRules`` and ``Parallel`` read only
``shape`` and ``axis_names``, so any object with those two drives them.

Ranks are laid out row-major: rank = 4 * data + model on a (2, 4)
``("data", "model")`` mesh, as the reference's ``jax.make_mesh`` orders
device ids.  Building a mesh calls into every rank's process group, so
every rank builds it, in the same order.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from .. import resolve_device
from ..distributed.collectives import world_size


class Mesh:
    """A ``DeviceMesh`` with named axes (module docstring)."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.mesh.shape))
        self.size = math.prod(self.shape.values())
        self._groups: dict[tuple, object] = {}

    def coordinate(self) -> dict[str, int]:
        """This rank's index along each axis."""
        return dict(zip(self.axis_names, self.device_mesh.get_coordinate()))

    def group(self, axis: str):
        """The process group of the ranks that differ from this one only
        along ``axis``."""
        return self.device_mesh.get_group(axis)

    def group_over(self, axes) -> object:
        """The process group of the ranks that differ from this one only
        along ``axes`` (ranked row-major over them, major first, as a
        dimension split over several axes orders its blocks).  Several
        axes: every rank builds every such group the first time, in one
        order (``new_subgroups_by_enumeration``)."""
        axes = tuple(axes)
        if len(axes) == 1:
            return self.group(axes[0])
        if axes not in self._groups:
            names = list(self.axis_names)
            rest = [a for a in names if a not in axes]
            grid = self.device_mesh.mesh.permute(
                *[names.index(a) for a in rest + list(axes)])
            lists = grid.reshape(-1, math.prod(self.shape[a] for a in axes))
            mine, _ = dist.new_subgroups_by_enumeration(lists.tolist())
            self._groups[axes] = mine
        return self._groups[axes]


def make_mesh(shape: tuple, axes: tuple, device="cuda") -> Mesh:
    """A mesh of ``shape`` over the first ``prod(shape)`` ranks, row-major
    (``jax.make_mesh``'s order); the process group must be initialised."""
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(math.prod(shape)).reshape(shape)
    return Mesh(DeviceMesh(resolve_device(device).type, ranks,
                           mesh_dim_names=tuple(axes)))


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks when ``multi_pod``.

    Axes: ("data", "model") single-pod, ("pod", "data", "model") multi-pod.
    Batch shards over ("pod", "data"); tensor/expert parallelism over
    "model" (see ``repro_torch.distributed.sharding``).  Raises
    ``RuntimeError`` when the process group has fewer ranks than the
    mesh; with more, the mesh takes the first ones.
    """
    resolve_device(device)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = world_size()
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, the process group has {have}: "
            f"launch {n} processes (one a device) and initialise "
            "torch.distributed before building the production mesh")
    return make_mesh(shape, axes, device)


def data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def make_host_mesh(device="cuda") -> Mesh:
    """(world size, 1) ``("data", "model")``.  Without a process group it
    initialises one of world size 1 first (NCCL on ``cuda``, gloo on
    ``cpu``), from an in-process store: no address, no port."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "gloo"
        if dev.type == "cuda":
            backend = "nccl"
            torch.cuda.set_device(dev.index or 0)   # NCCL's device
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return make_mesh((world_size(), 1), ("data", "model"), device)


__all__ = ["Mesh", "make_mesh", "make_production_mesh", "data_axes",
           "make_host_mesh"]
