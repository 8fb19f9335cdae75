"""Logical activation-sharding constraints.

Model code stays mesh-agnostic: it names the logical axes of an activation
(``"batch"``, ``"seq"``, ``"vocab"``, ...); a launcher binds logical names
to mesh axes around a sharded run.  With no binding (every single-card and
CPU path) ``constrain`` costs one dict check and returns its input itself.

With a binding, a ``DTensor`` input is redistributed to the bound
placements (JAX's ``with_sharding_constraint``); a plain tensor has no
placement to constrain and comes back as it is.
"""
from __future__ import annotations

import contextlib
from typing import Optional

_BINDING: dict[str, Optional[str | tuple[str, ...]]] = {}


@contextlib.contextmanager
def bind(mapping: dict[str, Optional[str | tuple[str, ...]]]):
    """Bind logical axis names -> mesh axes for the enclosed run."""
    global _BINDING
    old = _BINDING
    _BINDING = dict(mapping)
    try:
        yield
    finally:
        _BINDING = old


def constrain(x, *logical: Optional[str]):
    if not _BINDING:
        return x
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.partition import P, placements
    if not isinstance(x, DTensor):
        return x
    spec = P(*[_BINDING.get(name) if name else None for name in logical])
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def standard_binding(dp_axes: tuple[str, ...], model_axis: str = "model",
                     seq_parallel: bool = True):
    return {"batch": dp_axes, "vocab": model_axis, "heads": model_axis,
            "ffn": model_axis, "seq": model_axis if seq_parallel else None}
