"""Device meshes: JAX's production and debug mesh shapes as
``torch.distributed`` ``DeviceMesh``es.

Functions, not module-level meshes, so importing starts no process group.

  single-pod:  (data=16, model=16)            = 256 ranks
  multi-pod:   (pod=2, data=16, model=16)     = 512 ranks

A ``DeviceMesh`` is built over the default process group (the caller
initialises it: one rank a card, NCCL; gloo on the CPU), on ``"cuda"``
unless the caller asks for ``"cpu"``.  The stacked stand-in and the replica
axes of a mesh are in ``sharding/mesh.py``.

The roofline peaks the port uses are the H100 SXM data sheet's (989
TFLOP/s dense bf16, 3.35 TB/s HBM; ``chip_smoke.py``); no TPU constant is
kept here.
"""
from __future__ import annotations

from repro_torch.sharding.mesh import axis_names

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


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
    return _device_mesh(device_type, (data, model), ("data", "model"))


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in axis_names(mesh) if a != "model")
