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

    if m.dispatch == "dense" or n <= e:
        all_out = _expert_ffn(p["experts"], xf)                  # [E, N, d]
        combine = torch.zeros((n, e), dtype=xf.dtype, device=x.device)
        combine.scatter_(1, top_idx, gate_vals.to(xf.dtype))
        y = torch.einsum("end,ne->nd", all_out, combine)
    else:
        y = _gather_dispatch(p, cfg, x, gate_vals, top_idx).reshape(n, d)

    if m.num_shared:
        y = y + _expert_ffn(p["shared"], xf).sum(dim=0)
    return y.reshape(b, t, d), aux


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


def _gather_dispatch(p: Params, cfg: ModelConfig, x: torch.Tensor,
                     gate_vals: torch.Tensor, top_idx: torch.Tensor
                     ) -> torch.Tensor:
    """Capacity dispatch: assignments scatter into [E, B·C] expert rows
    (dropped ones into one spare row past them, which no expert reads),
    one batched matmul a weight bank, then each token sums its kept
    assignments' outputs times their gates.  Returns [B, T, d]."""
    m = cfg.moe
    b, t, d = x.shape
    tk, e = m.top_k, m.num_experts
    cap = capacity(cfg, t)
    slot, keep = slots(cfg, top_idx, b, t)
    e_bt = top_idx.reshape(b, t * tk)
    rows = b * cap
    # Row of slot min(slot, cap - 1): a kept assignment's own, a dropped
    # one's last (read back with weight 0, as JAX's clipped gather does).
    at = (e_bt * rows + torch.arange(b, device=x.device)[:, None] * cap
          + slot.clamp(max=cap - 1))                              # [B, TK]
    dest = torch.where(keep, at, e * rows)
    src = x[:, torch.arange(t, device=x.device).repeat_interleave(tk)]
    buf = torch.zeros((e * rows + 1, d), dtype=x.dtype, device=x.device)
    buf[dest.reshape(-1)] = src.reshape(-1, d)
    out = _expert_ffn(p["experts"], buf[:-1].view(e, rows, d))   # [E,BC,d]
    gathered = out.reshape(e * rows, d)[at]                       # [B,TK,d]
    w = (gate_vals.reshape(b, t * tk) * keep).to(x.dtype)
    return (gathered * w[..., None]).reshape(b, t, tk, d).sum(dim=2)
