"""Device meshes: JAX's production and debug mesh shapes as
``torch.distributed`` ``DeviceMesh``es.

Functions, not module-level meshes, so importing starts no process group.

  single-pod:  (data=16, model=16)            = 256 ranks
  multi-pod:   (pod=2, data=16, model=16)     = 512 ranks

A ``DeviceMesh`` is built over the default process group (the caller
initialises it: one rank a card, NCCL; gloo on the CPU), on ``"cuda"``
unless the caller asks for ``"cpu"``.  ``counting_mesh`` builds the same
shapes over a fake group of that many ranks in one process: its
collectives move nothing, so ``DTensor``s with ``meta`` shards run on it
and a dispatch mode can count what one rank computes and sends (the dry
run).  The stacked stand-in and the replica axes of a mesh are in
``sharding/mesh.py``.

The roofline peaks the port uses are the H100 SXM data sheet's (989
TFLOP/s dense bf16, 3.35 TB/s HBM; ``chip_smoke.py``); no TPU constant is
kept here.
"""
from __future__ import annotations

import contextlib
import math
from unittest import mock

from repro_torch.sharding.mesh import axis_names

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}
DEBUG_AXES = ("data", "model")


def _device_mesh(device_type: str, shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """JAX's production mesh over the default group (256 or 512 ranks)."""
    return _device_mesh(device_type, *PRODUCTION[multi_pod])


def make_debug_mesh(data: int = 2, model: int = 2,
                    device_type: str = "cuda"):
    """A small (data, model) mesh over the default group."""
    return _device_mesh(device_type, (data, model), DEBUG_AXES)


@contextlib.contextmanager
def counting_mesh(shape: tuple[int, ...], names: tuple[str, ...], *,
                  rank: int = 0):
    """A ``DeviceMesh`` of ``shape`` over a fake default group of
    ``prod(shape)`` ranks, seen from ``rank``, for the enclosed block.

    The fake backend (``torch.testing._internal``, part of PyTorch) takes
    every collective and moves nothing, on CPU and ``meta`` tensors, so
    one process runs rank ``rank``'s share of a sharded step.  The group
    is the process's default group: the caller must own the process (the
    dry run does; tests start it as a subprocess).  The group is
    destroyed on exit."""
    import torch.distributed as dist
    from torch.distributed.tensor import placement_types
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("counting_mesh needs a process with no default "
                           "process group: run it in its own process")
    dist.init_process_group("cpu:fake,meta:fake", store=FakeStore(),
                            rank=rank, world_size=math.prod(shape))
    patch = (mock.patch.object(placement_types, "shard_dim_alltoall",
                               _shard_dim_alltoall)
             if hasattr(placement_types, "shard_dim_alltoall")
             else contextlib.nullcontext())
    try:
        with patch:
            yield _device_mesh("cpu", shape, names)
    finally:
        dist.destroy_process_group()


def _shard_dim_alltoall(x, gather_dim, shard_dim, mesh, mesh_dim):
    """``DTensor``'s Shard -> Shard move as the all-to-all NCCL runs
    (on a CPU mesh ``DTensor`` falls back to an all-gather and a chunk,
    since gloo has no all-to-all; the fake group takes either)."""
    import torch
    return torch.ops._dtensor.shard_dim_alltoall(
        x, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)


def production_counting_mesh(*, multi_pod: bool = False):
    """``counting_mesh`` of JAX's production mesh: (data 16, model 16),
    or for the multi-pod mesh (data 32, model 16), its pod and data axes
    as one.  The partitioner shards every batch dim and FSDP dim over pod
    and data together (never over one of them), so a rank holds the same
    shards on either; and JAX's collectives over the data axes run on
    their 32-device groups at once, as they do on the one axis here
    (``DTensor`` would run one collective an axis, and plans moves on a
    tensor dim split over two mesh dims by a graph search that takes
    minutes a step)."""
    if multi_pod:
        (pod, data, model), _ = PRODUCTION[True]
        return counting_mesh((pod * data, model), DEBUG_AXES)
    return counting_mesh(*PRODUCTION[False])


def debug_counting_mesh(data: int = 2, model: int = 2):
    """``counting_mesh`` of a small (data, model) mesh."""
    return counting_mesh((data, model), DEBUG_AXES)


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in axis_names(mesh) if a != "model")
