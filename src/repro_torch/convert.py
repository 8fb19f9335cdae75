"""Carry JAX parameter, optimizer-state and cache trees across into the
port's layout.

Input trees hold numpy arrays (``jax.tree.map(np.asarray, tree)`` on the
JAX side; this module imports no JAX).  bfloat16 leaves (ml_dtypes) move
through a 16-bit integer view and float8_e4m3fn leaves (quantized page
pools) through a uint8 view, so every bit arrives as it left; int8 pools
and their f32 scales move as they are, as do the float32 leaves of the
recurrent layers (``log_lambda``, the states: RG-LRU's ``h``, xLSTM's
``c`` / ``n`` / ``m`` / ``h`` and ``C``).  A layer's leaves keep their own
axes under the [G] one (an MoE layer's expert banks [E, d, h], sLSTM's
``r`` [H, dh, 4dh]).  The JAX
trees stack the layers of each block-pattern slot on a leading [G] axis
(``jax.vmap`` in ``lm.init``, the scan in ``lm.init_cache``), and an
encoder-decoder model's encoder blocks on [E]; the port keeps one dict per
layer in execution order, so both are unstacked here.  Cache layers carry
across leaf for leaf whatever their layout (the whisper decoder's ``xattn``
layers with their cross-KV included).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import AdamWState


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
    p = {"embed": _map(tree["embed"], lambda a: to_tensor(a, device)),
         "final_norm": _map(tree["final_norm"],
                            lambda a: to_tensor(a, device)),
         "layers": _unstack(tree["groups"], tree.get("tail"), cfg, device)}
    if "head" in tree:
        p["head"] = _map(tree["head"], lambda a: to_tensor(a, device))
    if "encoder" in tree:
        e = tree["encoder"]
        p["encoder"] = {
            "pos": to_tensor(e["pos"], device),
            "blocks": [_map(e["blocks"],
                            lambda a, i=i: to_tensor(np.asarray(a)[i],
                                                     device))
                       for i in range(cfg.encoder.num_layers)],
            "norm": _map(e["norm"], lambda a: to_tensor(a, device))}
    return p


def cache_from_jax(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """A JAX ``lm.init_cache`` tree (numpy leaves) -> {"layers": [...]}, on
    the card unless the caller passes ``device="cpu"``."""
    device = resolve_device(device)
    return {"layers": _unstack(tree["groups"], tree.get("tail"), cfg,
                               device)}


def opt_state_from_jax(state, cfg: ModelConfig, device=None):
    """A JAX ``AdamWState`` (numpy leaves: ``step``, and ``mu`` / ``nu``
    in the stacked tree of ``lm.init``) -> the port's ``AdamWState``: the
    moments unstacked as :func:`params_from_jax` unstacks parameters, on
    the card unless the caller passes ``device="cpu"``, and the step an
    int32 scalar on the host."""
    return AdamWState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32),
        mu=params_from_jax(state.mu, cfg, device),
        nu=params_from_jax(state.nu, cfg, device))
