"""Mixture-of-Experts FFN: DeepSeekMoE-style shared + fine-grained routed
experts with top-k softmax routing (the ``moe`` and ``mla_moe`` kinds).

Two dispatch modes, as in the JAX package:

  * ``gather`` — GShard-style capacity dispatch, group-local per batch
    row: each row's (token, k) assignments take slots of their expert in
    token-major, k-minor order; an assignment past ``capacity`` is dropped
    (no slot, combine weight 0).  The expert products are one batched
    matmul over experts, ``[E, B·C, d] × [E, d, h]``, so each expert's
    weights are read once a call.
  * ``dense`` — every token through every expert, gated combine.  Used
    when ``dispatch == "dense"`` or the call has no more tokens than
    experts (a decode step), where capacity math would drop tokens.

On ``DTensor``s (a sharded run) the layer is expert-parallel, as the
partitioner's rule places the banks (experts on ``model``, the shared
experts' hidden dim on ``model``): every rank routes its own token rows
over all experts, dispatches them to its local experts only (the others'
assignments count as dropped there), and its partial output is summed
over ``model`` by the residual add that follows (an all-reduce); the aux
loss sums its counts over the data axes.  Dispatch is group-local per
batch row, so no token crosses ranks.

The top k are taken by a stable descending sort, so equal probabilities
go to the lowest expert index first, as ``jax.lax.top_k`` orders them.
The expert products are plain ``torch`` matmuls: the JAX package computes
them outside any Pallas kernel.  The Switch load-balancing aux loss is
returned beside the output.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import activation

Params = Any


def init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random weights in JAX's tree layout: a bf16 router [d, E] and expert
    banks ``gate`` / ``up`` [E, d, h], ``down`` [E, h, d] (float32 draws
    cast per tensor); the draws are the port's own."""
    m = cfg.moe
    d, h = cfg.d_model, m.d_expert
    dev = gen.device

    def expert_bank(n):
        def draw(shape, scale):
            return (torch.randn(shape, generator=gen, device=dev) * scale
                    ).to(common.PARAM_DTYPE)
        return {"gate": draw((n, d, h), d ** -0.5),
                "up": draw((n, d, h), d ** -0.5),
                "down": draw((n, h, d), h ** -0.5)}

    p = {"router": common.dense_init(gen, d, m.num_experts, False),
         "experts": expert_bank(m.num_experts)}
    if m.num_shared:
        p["shared"] = expert_bank(m.num_shared)
    return p


def _expert_ffn(bank: Params, x: torch.Tensor) -> torch.Tensor:
    """x: [E, C, d] (or [C, d], every expert's input) through per-expert
    SwiGLU: [E, C, d]."""
    dt = x.dtype
    g = torch.matmul(x, bank["gate"].to(dt))
    u = torch.matmul(x, bank["up"].to(dt))
    return torch.matmul(F.silu(g) * u, bank["down"].to(dt))


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, ties to the lowest index first
    (``jax.lax.top_k``'s order): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(cfg: ModelConfig, t: int) -> int:
    """Slots an expert has within one batch row of ``t`` tokens."""
    m = cfg.moe
    return max(int(m.capacity_factor * t * m.top_k / m.num_experts), 1)


def route(p: Params, cfg: ModelConfig, xf: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router over tokens xf [N, d]: (float32 probs [N, E], renormalised
    gates [N, K], expert ids [N, K])."""
    logits = common.dense(p["router"], xf).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, top_idx = top_k(probs, cfg.moe.top_k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, gate_vals, top_idx


def forward(p: Params, cfg: ModelConfig, x: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, T, d] -> (y [B, T, d], float32 aux loss)."""
    from repro_torch.models.cache import is_dtensor
    if is_dtensor(x):
        return _forward_sharded(p, cfg, x)
    m = cfg.moe
    b, t, d = x.shape
    n = b * t
    e = m.num_experts
    xf = x.reshape(n, d)
    probs, gate_vals, top_idx = route(p, cfg, xf)

    # Switch aux loss: E * sum_e f_e * P_e.
    routed = torch.zeros((e,), dtype=torch.float32, device=x.device)
    routed.index_add_(0, top_idx.reshape(-1),
                      torch.ones((top_idx.numel(),), dtype=torch.float32,
                                 device=x.device))
    aux = e * torch.sum(routed / n * probs.mean(dim=0))

    y = _experts(p["experts"], cfg, x, gate_vals, top_idx, 0, e)
    if m.num_shared:
        y = y + _expert_ffn(p["shared"], xf).sum(dim=0)
    return y.reshape(b, t, d), aux


def _experts(bank: Params, cfg: ModelConfig, x: torch.Tensor,
             gate_vals: torch.Tensor, top_idx: torch.Tensor, first: int,
             n_local: int) -> torch.Tensor:
    """The routed experts' combined output [N, d] from experts [first,
    first + n_local) of ``bank`` (which holds just those)."""
    b, t, d = x.shape
    n = b * t
    xf = x.reshape(n, d)
    if cfg.moe.dispatch == "dense" or n <= cfg.moe.num_experts:
        all_out = _expert_ffn(bank, xf)                          # [E, N, d]
        combine = torch.zeros((n, cfg.moe.num_experts), dtype=xf.dtype,
                              device=x.device)
        combine.scatter_(1, top_idx, gate_vals.to(xf.dtype))
        return torch.einsum("end,ne->nd", all_out,
                            combine[:, first:first + n_local])
    return _gather_dispatch(bank, cfg, x, gate_vals, top_idx, first,
                            n_local).reshape(n, d)


def _forward_sharded(p: Params, cfg: ModelConfig, x
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``forward`` on ``DTensor``s, expert-parallel over ``model``.  The
    router runs on ``DTensor``s; the experts on each rank's rows and
    experts, whose gradients (to the rows, the gates and, in a training
    run, the banks) are partial sums over the ranks that share them."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    m = cfg.moe
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    b, t, d = x.shape
    e = m.num_experts
    # Rows stay on their data ranks; every model rank holds them whole.
    rows = tuple(Shard(0) if name != "model" and pl == Shard(0)
                 else Replicate() for name, pl in zip(names, x.placements))
    on_model = tuple(Partial() if name == "model" else r
                     for name, r in zip(names, rows))
    probs, gate_vals, top_idx = route(
        p, cfg, x.redistribute(mesh, rows).reshape(b * t, d))
    xl = x.redistribute(mesh, rows).to_local(grad_placements=on_model)
    gates = gate_vals.redistribute(mesh, rows).to_local(
        grad_placements=on_model)
    ids = top_idx.redistribute(mesh, rows).to_local()

    def local(w):
        # FSDP's all-gather of a bank in a training run; each data rank's
        # rows give a partial gradient.
        w = activation.fsdp_gathered(w)
        return w.to_local(grad_placements=tuple(
            Partial() if r == Shard(0) else q
            for r, q in zip(rows, w.placements)))

    def summed(y, sharded: bool):
        # A bank split over model gives a partial sum a model rank.
        return DTensor.from_local(y.reshape(xl.shape[0], t, d), mesh,
                                  on_model if sharded else rows,
                                  run_check=False, shape=x.shape,
                                  stride=x.stride())

    bank = {k: local(v) for k, v in p["experts"].items()}
    n_local = bank["gate"].shape[0]
    first = (mesh.get_local_rank("model") * n_local if n_local < e else 0)
    y = summed(_experts(bank, cfg, xl, gates, ids, first, n_local),
               n_local < e)
    if m.num_shared:
        shared = {k: local(v) for k, v in p["shared"].items()}
        y = y + summed(_expert_ffn(shared, xl.reshape(-1, d)).sum(dim=0),
                       shared["down"].shape[1] < m.d_expert)

    # Switch aux loss over every row: counts summed over the data ranks
    # holding rows, probabilities through the router's DTensors.
    routed = torch.zeros((e,), dtype=torch.float32, device=xl.device)
    routed.index_add_(0, ids.reshape(-1),
                      torch.ones((ids.numel(),), dtype=torch.float32,
                                 device=xl.device))
    routed = DTensor.from_local(routed, mesh, tuple(
        Partial() if r == Shard(0) else Replicate() for r in rows),
        run_check=False)
    n = b * t
    aux = e * torch.sum(routed / n * probs.mean(dim=0))
    return y, aux


def slots(cfg: ModelConfig, top_idx: torch.Tensor, b: int, t: int
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each assignment's slot within its expert and batch row, token-major
    and k-minor (a cumsum over the row's assignments), and whether it
    fits in ``capacity``: (slot, keep), both [B, T·K]."""
    e_bt = top_idx.reshape(b, t * cfg.moe.top_k)
    eq = e_bt[..., None] == torch.arange(cfg.moe.num_experts,
                                         device=e_bt.device)     # [B,TK,E]
    pos = torch.cumsum(eq, dim=1) - 1
    slot = pos.gather(2, e_bt[..., None])[..., 0]
    return slot, slot < capacity(cfg, t)


def _gather_dispatch(bank: Params, cfg: ModelConfig, x: torch.Tensor,
                     gate_vals: torch.Tensor, top_idx: torch.Tensor,
                     first: int = 0, n_local: int | None = None
                     ) -> torch.Tensor:
    """Capacity dispatch: assignments scatter into [E, B·C] expert rows
    (dropped ones into one spare row past them, which no expert reads),
    one batched matmul a weight bank, then each token sums its kept
    assignments' outputs times their gates.  Only experts [first, first +
    n_local) are in ``bank`` (all of them unless sharded): an assignment
    to another expert is dropped here.  Returns [B, T, d]."""
    m = cfg.moe
    b, t, d = x.shape
    tk = m.top_k
    e = m.num_experts if n_local is None else n_local
    cap = capacity(cfg, t)
    slot, keep = slots(cfg, top_idx, b, t)
    e_bt = top_idx.reshape(b, t * tk) - first
    if e != m.num_experts:
        keep = keep & (e_bt >= 0) & (e_bt < e)
        e_bt = e_bt.clamp(0, e - 1)
    rows = b * cap
    # Row of slot min(slot, cap - 1): a kept assignment's own, a dropped
    # one's last (read back with weight 0, as JAX's clipped gather does).
    at = (e_bt * rows + torch.arange(b, device=x.device)[:, None] * cap
          + slot.clamp(max=cap - 1))                              # [B, TK]
    dest = torch.where(keep, at, e * rows)
    src = x[:, torch.arange(t, device=x.device).repeat_interleave(tk)]
    buf = torch.zeros((e * rows + 1, d), dtype=x.dtype, device=x.device)
    buf[dest.reshape(-1)] = src.reshape(-1, d)
    out = _expert_ffn(bank, buf[:-1].view(e, rows, d))           # [E,BC,d]
    gathered = out.reshape(e * rows, d)[at]                       # [B,TK,d]
    w = (gate_vals.reshape(b, t * tk) * keep).to(x.dtype)
    return (gathered * w[..., None]).reshape(b, t, tk, d).sum(dim=2)
