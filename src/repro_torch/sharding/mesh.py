"""Mesh axes as the merges and the partitioner read them, for a
``torch.distributed`` ``DeviceMesh`` and for its stacked stand-in.

``StackedMesh`` has a mesh's axis names and sizes with every replica in one
process, stacked on the leading dim of each leaf (``merge.StackedAxis``):
what JAX's ``vmap(..., axis_name=)`` runs.  ``replica_axes`` turns either
kind of mesh into the replica axes the collective merges take.  The meshes
themselves are built in ``launch/mesh.py``.
"""
from __future__ import annotations

import math

from repro_torch.core.merge import GroupAxis, StackedAxis


class StackedMesh:
    """A mesh's axis names and sizes with every replica in one process."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...]):
        if len(shape) != len(axis_names):
            raise ValueError(f"{len(shape)} sizes for axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))

    def __repr__(self) -> str:
        return f"StackedMesh({self.shape})"


def axis_names(mesh) -> tuple[str, ...]:
    """A ``DeviceMesh``'s dim names, or a stand-in's ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a stand-in (whose
    ``shape`` is that dict already, as a JAX ``Mesh``'s is)."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def replica_axes(mesh, names: tuple[str, ...]) -> tuple:
    """The replica axes over mesh axes ``names``, in order: a
    ``StackedAxis`` each on the grid of ``names`` for a ``StackedMesh``,
    a ``GroupAxis`` on each axis' group for a ``DeviceMesh``."""
    if isinstance(mesh, StackedMesh):
        grid = tuple(mesh.shape[a] for a in names)
        return tuple(StackedAxis(grid, i) for i in range(len(names)))
    return tuple(GroupAxis(mesh.get_group(a)) for a in names)


def local_replicas(mesh, names: tuple[str, ...]) -> int:
    """Replicas one process holds: all of them on a ``StackedMesh``, its
    own on a rank of a ``DeviceMesh``."""
    if isinstance(mesh, StackedMesh):
        return math.prod(mesh.shape[a] for a in names)
    return 1
