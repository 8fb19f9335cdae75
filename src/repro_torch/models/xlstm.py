"""xLSTM blocks: sLSTM (scalar memory, recurrent gates) and mLSTM (matrix
memory) — arXiv:2405.04517, the ``slstm`` and ``mlstm`` kinds of
xlstm-125m, which alternates them.

Both use the paper's stabilised exponential gating: a running max ``m``
(initialised to ``M_INIT``) keeps exp() bounded, in float32 whatever the
activations' dtype.  sLSTM has recurrent weights, block-diagonal per head
[H, dh, 4dh]; mLSTM keeps a [H, dh, dh] matrix state.  The time scan is a
Python loop over the span (the JAX package's chunk-remat scan is for
training).  A ragged forward (``lengths``) keeps each row's state bit for
bit past its length, so rows of span 0 are untouched: the mixed serve
step is that forward with the rows' spans.  Decode is an O(1) state
update.  The JAX package has no kernel here, and neither has the port.
The functions return new state tensors rather than write in place.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.models import scan as scan_mod
from repro_torch.sharding import activation
from repro_torch.models.config import ModelConfig

Params = Any

M_INIT = -10.0                  # the stabiliser's fill in a fresh state
STATE_FILLS = {"m": M_INIT}


def _masked_state(valid_t: torch.Tensor, new: dict, old: dict) -> dict:
    """Per row: ``new`` where ``valid_t`` [B], else ``old`` bit for bit."""
    return {k: torch.where(valid_t.reshape((-1,) + (1,) * (v.dim() - 1)),
                           v, old[k]) for k, v in new.items()}


def _scan(step, state: dict, xs: tuple, lengths: Optional[torch.Tensor],
          emit: str | None = None):
    """Run ``step(state, *x_t) -> (state, y_t)`` over axis 1 of ``xs``;
    with ``lengths``, steps at t >= lengths[b] keep row b's state.  The
    output of a step is y_t, or with ``emit`` that leaf of the state after
    the mask (sLSTM's h, as in JAX).  Returns (state, ys on axis 1)."""
    xs = tuple(activation.whole_dim(x, 1) for x in xs)
    t = xs[0].shape[1]
    if lengths is not None:
        lengths = lengths.to(xs[0].device)
    names = sorted(state)
    one = scan_mod.once(t, [state[k] for k in names] + list(xs))
    if one is not None:
        # The dry run's counter: one step counted t times (models/scan.py).
        ins = one.enter([state[k] for k in names] + list(xs))
        state, xs = dict(zip(names, ins)), tuple(ins[len(names):])
    ys = []
    for i in range(1 if one is not None else t):
        new, y = step(state, *(x[:, i] for x in xs))
        state = new if lengths is None else _masked_state(i < lengths, new,
                                                          state)
        ys.append(y if emit is None else state[emit])
    if one is not None:
        outs = one.exit([state[k] for k in names] + ys)
        state, ys = dict(zip(names, outs)), outs[len(names):] * t
    return state, torch.stack(ys, dim=1)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random weights in JAX's layout; gates (i, f, z, o): input weights
    [d, 4d], recurrent weights [H, dh, 4dh].  The draws are the port's."""
    d, h = cfg.d_model, cfg.num_heads
    dh = d // h
    return {
        "w_in": common.dense_init(gen, d, 4 * d),
        "r": (torch.randn((h, dh, 4 * dh), generator=gen, device=gen.device)
              * dh ** -0.5).to(common.PARAM_DTYPE),
        "out": common.dense_init(gen, d, d),
        "norm": common.norm_init(d, "rmsnorm", gen.device),
    }


def slstm_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    d = cfg.d_model

    def z():
        return torch.zeros((batch, d), dtype=torch.float32, device=device)
    return {"c": z(), "n": z(), "m": z() + M_INIT, "h": z()}


def _slstm_cell(p: Params, cfg: ModelConfig, wx_t: torch.Tensor,
                state: dict) -> tuple[dict, torch.Tensor]:
    """wx_t: [B, 4d] input contribution; state: dict of [B, d] float32."""
    # On DTensors: each rank's rows and heads, the contracted d whole.
    h_heads = activation.whole_dim(
        activation.split_last(state["h"], cfg.num_heads), -1).float()
    rh = activation.merge_last(activation.einsum(
        "bhd,hde->bhe", h_heads, p["r"].float()), 2)            # [B, 4d]
    pre = wx_t.float() + rh
    i_p, f_p, z_p, o_p = torch.chunk(pre, 4, dim=-1)
    m_new = torch.maximum(f_p + state["m"], i_p)                  # log-space
    i_g = torch.exp(i_p - m_new)
    f_g = torch.exp(f_p + state["m"] - m_new)
    c = f_g * state["c"] + i_g * torch.tanh(z_p)
    n = f_g * state["n"] + i_g
    h = torch.sigmoid(o_p) * c / torch.clamp(n, min=1.0)
    return {"c": c, "n": n, "m": m_new, "h": h}, h


def _slstm_out(p: Params, cfg: ModelConfig, hs: torch.Tensor,
               dtype) -> torch.Tensor:
    y = common.apply_norm(p["norm"], hs.to(dtype), "rmsnorm", cfg.norm_eps)
    return common.dense(p["out"], y)


def slstm_forward(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  state: dict | None = None,
                  lengths: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, dict | None]:
    """x: [B, T, d].  ``lengths`` (i32[B]): a ragged right-padded batch —
    padding steps keep each row's state bit for bit.  Returns (y, the new
    state, or None when no state was passed)."""
    keep_state = state is not None
    if state is None:
        state = slstm_state(cfg, x.shape[0], x.device)
    wx = common.dense(p["w_in"], x)                               # [B,T,4d]
    state, hs = _scan(lambda s, w: _slstm_cell(p, cfg, w, s), state, (wx,),
                      lengths, emit="h")
    return _slstm_out(p, cfg, hs, x.dtype), (state if keep_state else None)


def slstm_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 state: dict) -> tuple[torch.Tensor, dict]:
    """One token, x: [B, 1, d]."""
    state, h = _slstm_cell(p, cfg, common.dense(p["w_in"], x)[:, 0], state)
    return _slstm_out(p, cfg, h[:, None], x.dtype), state


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d = cfg.d_model
    up = int(cfg.proj_factor * d)
    return {
        "up_mlstm": common.dense_init(gen, d, up),
        "up_gate": common.dense_init(gen, d, up),
        "wq": common.dense_init(gen, up, up),
        "wk": common.dense_init(gen, up, up),
        "wv": common.dense_init(gen, up, up),
        "w_if": common.dense_init(gen, up, 2 * cfg.num_heads),
        "down": common.dense_init(gen, up, d),
        "norm": common.norm_init(up, "rmsnorm", gen.device),
    }


def mlstm_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    h = cfg.num_heads
    dh = int(cfg.proj_factor * cfg.d_model) // h
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, h, dh, dh), **f32),
            "n": torch.zeros((batch, h, dh), **f32),
            "m": torch.zeros((batch, h), **f32) + M_INIT}


def _mlstm_cell(state: dict, q_t, k_t, v_t, i_p, f_p
                ) -> tuple[dict, torch.Tensor]:
    """One step.  q/k/v: [B, H, dh]; i_p / f_p: [B, H] pre-activations."""
    f_log = activation.elementwise(F.logsigmoid, f_p.float())
    m_new = torch.maximum(f_log + state["m"], i_p.float())
    i_g = torch.exp(i_p - m_new)[..., None]                       # [B,H,1]
    f_g = torch.exp(f_log + state["m"] - m_new)[..., None]
    kf, vf, qf = k_t.float(), v_t.float(), q_t.float()
    c = f_g[..., None] * state["C"] + i_g[..., None] * (
        vf[..., :, None] * kf[..., None, :])                      # [B,H,dh,dh]
    n = f_g * state["n"] + i_g * kf
    # On DTensors: each rank's rows and heads, the contracted dim whole.
    qw = activation.whole_dim(qf, -1)
    denom = torch.clamp(activation.einsum(
        "bhd,bhd->bh", activation.whole_dim(n, -1), qw).abs(), min=1.0)
    h_t = activation.einsum("bhde,bhe->bhd", activation.whole_dim(c, -1),
                            qw) / denom[..., None]
    return {"C": c, "n": n, "m": m_new}, h_t


def _mlstm_qkvif(p: Params, cfg: ModelConfig, xu: torch.Tensor):
    b, t, up = xu.shape
    h = cfg.num_heads
    dh = up // h

    def split(z):
        return activation.split_last(z, h)
    q = split(common.dense(p["wq"], xu))
    k = split(common.dense(p["wk"], xu)) * dh ** -0.5
    v = split(common.dense(p["wv"], xu))
    gates = common.dense(p["w_if"], xu).reshape(b, t, 2, h)
    return q, k, v, gates[:, :, 0], gates[:, :, 1]


def _mlstm_out(p: Params, cfg: ModelConfig, hs: torch.Tensor,
               gate: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    h = activation.merge_last(hs, 2).to(x.dtype)
    h = common.apply_norm(p["norm"], h, "rmsnorm", cfg.norm_eps)
    return common.dense(p["down"], h * gate)


def mlstm_forward(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  state: dict | None = None,
                  lengths: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, dict | None]:
    """As :func:`slstm_forward`, for the mLSTM block."""
    keep_state = state is not None
    if state is None:
        state = mlstm_state(cfg, x.shape[0], x.device)
    xu = common.dense(p["up_mlstm"], x)
    gate = F.silu(common.dense(p["up_gate"], x))
    state, hs = _scan(_mlstm_cell, state, _mlstm_qkvif(p, cfg, xu), lengths)
    return (_mlstm_out(p, cfg, hs, gate, x),
            state if keep_state else None)


def mlstm_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 state: dict) -> tuple[torch.Tensor, dict]:
    """One token, x: [B, 1, d]."""
    xu = common.dense(p["up_mlstm"], x)
    gate = F.silu(common.dense(p["up_gate"], x))
    q, k, v, i_p, f_p = _mlstm_qkvif(p, cfg, xu)
    state, h_t = _mlstm_cell(state, q[:, 0], k[:, 0], v[:, 0], i_p[:, 0],
                             f_p[:, 0])
    return _mlstm_out(p, cfg, h_t[:, None], gate, x), state
