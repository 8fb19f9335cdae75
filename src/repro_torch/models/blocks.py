"""Block assembly: pre-norm residual wiring of the ported block kinds.

The port runs layers in a Python loop (``lm._run_blocks``) where the JAX
package scans over stacked groups.  Ported so far: dense attention
(``attn``), sliding-window attention (``local``: the ``attn`` wiring with
the config's window kept), latent attention with a dense FFN (``mla``) and
Griffin's recurrent block (``rglru``: RG-LRU, then the FFN).  Every other
kind raises NotImplementedError naming its ROADMAP.md queue 1 item.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.models import attention, common, ffn, mla, rglru
from repro_torch.models import cache as cache_mod
from repro_torch.models.config import ModelConfig

Params = Any


class BlockCtx(NamedTuple):
    """Per-call context shared by all blocks."""
    positions: torch.Tensor               # [B, T] (or [T])
    mask_full: Optional[torch.Tensor]     # bool[Tq, Tk] / [B, Tq, Tk] or None
    mode: str = "full"                    # "full"|"prefill"|"decode"|"mixed"
    pos: Optional[torch.Tensor] = None    # i32[B] cache fill level
    impl: str = "kernel"
    lengths: Optional[torch.Tensor] = None   # i32[B] ragged lengths / spans
    mask_local: Optional[torch.Tensor] = None  # mask_full within the window


PORTED_KINDS = ("attn", "local", "mla", "rglru")


def check_kind(kind: str) -> None:
    """Raise for a block kind the port does not run (yet)."""
    if kind not in PORTED_KINDS:
        cache_mod.layout_for(kind, None, paged=False)   # names the item


def block_init(kind: str, gen: torch.Generator, cfg: ModelConfig) -> Params:
    check_kind(kind)
    d = cfg.d_model
    if kind in ("mla", "rglru"):
        mixer = ({"attn": mla.init(gen, cfg)} if kind == "mla"
                 else {"rec": rglru.init(gen, cfg)})
        return {"norm1": common.norm_init(d, cfg.norm_type, gen.device),
                **mixer,
                "norm2": common.norm_init(d, cfg.norm_type, gen.device),
                "ffn": ffn.init(gen, cfg)}
    p = {"norm1": common.norm_init(d, cfg.norm_type, gen.device),
         "attn": attention.init(gen, cfg)}
    if not cfg.parallel_block:
        p["norm2"] = common.norm_init(d, cfg.norm_type, gen.device)
    p["ffn"] = ffn.init(gen, cfg)
    return p


def _norm(p, cfg, x):
    return common.apply_norm(p, x, cfg.norm_type, cfg.norm_eps)


def block_apply(kind: str, p: Params, cfg: ModelConfig, x: torch.Tensor,
                ctx: BlockCtx, cache: Params | None
                ) -> tuple[torch.Tensor, Params | None]:
    """Returns (x, cache).  The window applies to ``local`` layers only."""
    check_kind(kind)
    h = _norm(p["norm1"], cfg, x)
    if kind == "mla":
        return _mla_apply(p, cfg, x, h, ctx, cache)
    if kind == "rglru":
        return _rglru_apply(p, cfg, x, h, ctx, cache)
    mask = ctx.mask_local if kind == "local" else ctx.mask_full
    local_cfg = cfg if kind == "local" else cfg.replace(window=None)
    if ctx.mode == "mixed":
        a, cache = attention.mixed_step(p["attn"], local_cfg, h, cache,
                                        ctx.pos, ctx.lengths, ctx.positions,
                                        ctx.impl)
    elif ctx.mode == "decode":
        a, cache = attention.decode_step(p["attn"], local_cfg, h, cache,
                                         ctx.pos, ctx.impl)
    elif cache is not None:
        a, cache = attention.prefill(p["attn"], local_cfg, h, cache, mask,
                                     ctx.positions, lengths=ctx.lengths)
    else:
        a = attention.forward(p["attn"], local_cfg, h, mask, ctx.positions)
    if cfg.parallel_block:
        return x + a + ffn.forward(p["ffn"], cfg, h), cache
    x = x + a
    f = ffn.forward(p["ffn"], cfg, _norm(p["norm2"], cfg, x))
    return x + f, cache


def _mla_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
               h: torch.Tensor, ctx: BlockCtx, cache: Params | None
               ) -> tuple[torch.Tensor, Params | None]:
    """The ``mla`` kind: latent attention, then the dense FFN (never in
    parallel, as in the JAX package)."""
    if ctx.mode == "mixed":
        a, cache = mla.mixed_step(p["attn"], cfg, h, cache, ctx.pos,
                                  ctx.lengths, ctx.positions, ctx.impl)
    elif ctx.mode == "decode":
        a, cache = mla.decode_step(p["attn"], cfg, h, cache, ctx.pos,
                                   ctx.impl)
    elif cache is not None:
        a, cache = mla.prefill(p["attn"], cfg, h, cache, ctx.mask_full,
                               ctx.positions, lengths=ctx.lengths)
    else:
        a = mla.forward(p["attn"], cfg, h, ctx.mask_full, ctx.positions)
    x = x + a
    return x + ffn.forward(p["ffn"], cfg, _norm(p["norm2"], cfg, x)), cache


def _rglru_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 h: torch.Tensor, ctx: BlockCtx, cache: Params | None
                 ) -> tuple[torch.Tensor, Params | None]:
    """The ``rglru`` kind: the recurrent block, then the FFN.  A mixed step
    is a ragged forward over the rows' spans: identity steps past each
    span, so span-0 rows keep their state bit for bit."""
    if ctx.mode == "decode":
        r, cache = rglru.decode_step(p["rec"], cfg, h, cache)
    else:
        r, cache = rglru.forward(p["rec"], cfg, h, cache, ctx.impl,
                                 lengths=ctx.lengths)
    x = x + r
    return x + ffn.forward(p["ffn"], cfg, _norm(p["norm2"], cfg, x)), cache
