"""The training step: loss → grads → AdamW, with optional microbatch
gradient accumulation and activation recomputation.

The loss runs the plain path (``impl="ref"``), as the JAX reference's
does: no kernel of either package has a backward, and the kernel wrappers
raise on the card when asked for one.  The products are ``torch.matmul``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import tree
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import AdamW, AdamWState

Params = Any


def to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _placed_as(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A ``DTensor`` gradient under its parameter's placements (FSDP's
    reduce-scatter of a partial sum); a plain one as it is."""
    from torch.distributed.tensor import DTensor
    if isinstance(g, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _microbatch(v: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Rows [i·B/n, (i+1)·B/n) of a batch leaf: a contiguous part, as
    JAX's reshape to [n, B/n, ...] takes it.  A ``DTensor`` batch keeps
    its placements (the part is resharded over the data axes)."""
    from torch.distributed.tensor import DTensor
    if isinstance(v, DTensor):
        b = v.shape[0] // n
        return v[i * b:(i + 1) * b].redistribute(v.device_mesh, v.placements)
    return v.reshape(n, -1, *v.shape[1:])[i]


def make_train_step(cfg: ModelConfig, opt: AdamW, *, impl: str = "ref",
                    remat: bool = True, microbatches: int = 1,
                    aux_weight: float = 0.01):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics).  ``params`` are updated in place (and returned); every leaf
    is made to require grad, and each must receive a gradient.  With
    ``microbatches`` > 1 the batch splits into that many contiguous parts
    along its rows; their grads accumulate in float32 and are averaged,
    and the metrics are the last part's (``loss`` the mean)."""

    def grads_of(params, leaves, mb):
        loss, metrics = lm.loss_fn(params, cfg, mb, impl=impl,
                                   aux_weight=aux_weight, remat=remat)
        grads = [_placed_as(g, p)
                 for g, p in zip(torch.autograd.grad(loss, leaves), leaves)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def train_step(params: Params, opt_state: AdamWState, batch: dict):
        leaves = [p.requires_grad_() for p in tree.leaves(params)]
        batch = to_device(batch, leaves[0].device)
        if microbatches == 1:
            loss, metrics, grads = grads_of(params, leaves, batch)
        else:
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            for i in range(microbatches):
                mb = {k: _microbatch(v, i, microbatches)
                      for k, v in batch.items()}
                l, metrics, g = grads_of(params, leaves, mb)
                for a, gi in zip(acc, g):
                    a.add_(gi)
                loss = loss + l
            grads = [a / microbatches for a in acc]
            loss = loss / microbatches
        params, opt_state, opt_metrics = opt.update(grads, opt_state, params)
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics)

    return train_step


def make_eval_step(cfg: ModelConfig, *, impl: str = "ref"):
    """Returns eval_step(params, batch) -> metrics (``loss`` included),
    computed under ``torch.no_grad()``."""

    @torch.no_grad()
    def eval_step(params: Params, batch: dict):
        batch = to_device(batch, tree.leaves(params)[0].device)
        loss, metrics = lm.loss_fn(params, cfg, batch, impl=impl)
        return dict(metrics, loss=loss)

    return eval_step
