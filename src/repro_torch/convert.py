"""Carry JAX parameter and cache trees across into the port's layout.

Input trees hold numpy arrays (``jax.tree.map(np.asarray, tree)`` on the
JAX side; this module imports no JAX).  bfloat16 leaves (ml_dtypes) move
through a 16-bit integer view and float8_e4m3fn leaves (quantized page
pools) through a uint8 view, so every bit arrives as it left; int8 pools
and their f32 scales move as they are, as do the float32 leaves of the
recurrent layers (``log_lambda``, the state ``h``).  The JAX
trees stack the layers of each block-pattern slot on a leading [G] axis
(``jax.vmap`` in ``lm.init``, the scan in ``lm.init_cache``); the port keeps
one dict per layer in execution order, so groups are unstacked here.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig


def to_tensor(a, device=None) -> torch.Tensor:
    """A numpy array as a tensor with the same bits (bf16 included), on
    ``device`` (the card unless the caller passes ``"cpu"``)."""
    device = resolve_device(device)
    a = np.array(a, order="C")            # a writable copy
    views = {"bfloat16": (np.int16, torch.bfloat16),
             "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}
    if a.dtype.name in views:
        np_view, dtype = views[a.dtype.name]
        return torch.from_numpy(a.view(np_view)).view(dtype).to(device)
    return torch.from_numpy(a).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bf16 and fp8 come back as float32 (exact)."""
    t = t.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float8_e4m3fn):
        t = t.float()
    return t.numpy()


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _unstack(groups: dict, tail: dict | None, cfg: ModelConfig,
             device) -> list:
    """Per-layer dicts in execution order: group g runs the pattern slots
    0..len(pattern)-1, then the unstacked tail blocks follow."""
    layers = []
    for g in range(cfg.pattern_groups):
        for i in range(len(cfg.block_pattern)):
            layers.append(_map(groups[str(i)],
                               lambda a, g=g: to_tensor(np.asarray(a)[g],
                                                        device)))
    for i in range(len(cfg.tail_blocks)):
        layers.append(_map(tail[str(i)], lambda a: to_tensor(a, device)))
    return layers


def params_from_jax(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """A JAX ``lm.init`` tree (numpy leaves) -> the port's parameters, on
    the card unless the caller passes ``device="cpu"``."""
    device = resolve_device(device)
    if "encoder" in tree:
        raise NotImplementedError(
            "encoder-decoder parameters are not ported yet: ROADMAP.md "
            "queue 1 item 11 (remaining families)")
    p = {"embed": _map(tree["embed"], lambda a: to_tensor(a, device)),
         "final_norm": _map(tree["final_norm"],
                            lambda a: to_tensor(a, device)),
         "layers": _unstack(tree["groups"], tree.get("tail"), cfg, device)}
    if "head" in tree:
        p["head"] = _map(tree["head"], lambda a: to_tensor(a, device))
    return p


def cache_from_jax(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """A JAX ``lm.init_cache`` tree (numpy leaves) -> {"layers": [...]}, on
    the card unless the caller passes ``device="cpu"``."""
    device = resolve_device(device)
    return {"layers": _unstack(tree["groups"], tree.get("tail"), cfg,
                               device)}
