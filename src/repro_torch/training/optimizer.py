"""AdamW with global-norm clipping and a warmup + cosine schedule.

The arithmetic is the JAX reference's: float32 moments, the global norm in
float32 over every gradient leaf, then the clip scale, bias correction,
decoupled weight decay on the float32 parameter, and the result cast back
to the parameter's dtype.  ``update`` writes the moments and parameters in
place under ``torch.no_grad()`` (PyTorch's idiom: no second copy of a
1 B-parameter model), and returns the same trees.

The step count lives on the host (an int32 scalar on the CPU), so the
learning rate and the bias corrections are host scalars and the update
never waits for the card.  ``zero1_specs`` gives the moments' ZeRO-1
partition specs from the partitioner's parameter specs.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import tree

Params = Any


class AdamWState(NamedTuple):
    step: torch.Tensor    # int32 scalar on the CPU
    mu: Params            # float32, on the parameters' device
    nu: Params            # float32


class AdamW(NamedTuple):
    lr_peak: float = 3e-4
    warmup: int = 200
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params: Params) -> AdamWState:
        z = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return AdamWState(step=torch.zeros((), dtype=torch.int32),
                          mu=tree.map(z, params), nu=tree.map(z, params))

    def lr(self, step) -> float:
        """The learning rate at ``step``, in float32 as JAX computes it:
        linear warmup, then a cosine from ``lr_peak`` down to a tenth."""
        f = np.float32
        step = f(int(step))
        warm = step / f(max(self.warmup, 1))
        decay_steps = f(max(self.total_steps - self.warmup, 1))
        t = np.clip((step - f(self.warmup)) / decay_steps, f(0), f(1))
        cos = f(0.5) * (f(1) + np.cos(f(math.pi) * t))
        return float(f(self.lr_peak) * (warm if step < self.warmup
                                         else f(0.1) + f(0.9) * cos))

    @torch.no_grad()
    def update(self, grads: Params, state: AdamWState, params: Params
               ) -> tuple[Params, AdamWState, dict[str, torch.Tensor]]:
        """One step from ``grads`` (any float dtype: a tree like
        ``params``, or its leaves in ``tree.leaves`` order).  Returns
        (params, state, {"grad_norm", "lr"}); the parameter and moment
        tensors are the ones passed in, updated."""
        g_l = tree.leaves(grads)
        gnorm = torch.sqrt(sum(g.float().square().sum() for g in g_l))
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        step = int(state.step) + 1
        lr = self.lr(step)
        b1c = float(np.float32(1) - np.float32(self.b1) ** np.float32(step))
        b2c = float(np.float32(1) - np.float32(self.b2) ** np.float32(step))
        for g, m, v, p in zip(g_l, tree.leaves(state.mu),
                              tree.leaves(state.nu), tree.leaves(params)):
            g = g.float() * scale
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).add_(g.square_(), alpha=1 - self.b2)
            delta = (m / b1c) / ((v / b2c).sqrt_() + self.eps)
            pf = p.float()
            delta.add_(pf, alpha=self.weight_decay)
            p.copy_(pf.sub_(delta, alpha=lr))
        new_state = AdamWState(torch.tensor(step, dtype=torch.int32),
                               state.mu, state.nu)
        return params, new_state, {
            "grad_norm": gnorm,
            "lr": torch.tensor(lr, dtype=torch.float32)}


def zero1_specs(param_specs: Params, params: Params,
                data_axes: tuple[str, ...], data_size: int) -> Params:
    """Adam-moment partition specs: a parameter's spec with its first
    replicated, divisible dim sharded over the data axes (ZeRO-1).

    JAX's rule on a layer's own spec and shape.  JAX applies it to moments
    stacked [G, ...] a block-pattern slot, so wherever G divides the data
    size it shards the layer axis (full OLMo-1B: 16 layers on the
    production mesh's data = 16); the port keeps one tensor a layer and
    shards the first such dim of the layer's shape instead."""
    from repro_torch.sharding.partition import P

    def moment_spec(spec, leaf):
        shape = tuple(leaf.shape)
        parts = list(spec) + [None] * (len(shape) - len(spec))
        for i, (ax, dim) in enumerate(zip(parts, shape)):
            if ax is None and dim % data_size == 0 and dim >= data_size:
                parts[i] = data_axes
                break
        return P(*parts)

    return tree.map(moment_spec, param_specs, params,
                    is_leaf=lambda x: isinstance(x, P))
