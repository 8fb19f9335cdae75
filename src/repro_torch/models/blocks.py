"""Block assembly: pre-norm residual wiring of every block kind.

The port runs layers in a Python loop (``lm._run_blocks``) where the JAX
package scans over stacked groups.  The kinds (``PORTED_KINDS``, all of
the JAX package's):
  attn / local     attention (+FFN), full or sliding-window (``local``
                   keeps the config's window)
  moe              full attention + the MoE FFN (``models/moe.py``)
  mla / mla_moe    latent attention + the dense or the MoE FFN
  rglru            Griffin's recurrent block (RG-LRU, then the FFN)
  slstm / mlstm    xLSTM blocks (``models/xlstm.py``; no extra FFN)
  xattn            the whisper decoder block: causal self-attention,
                   cross-attention over the encoder output, then the FFN
``block_apply`` returns each layer's aux loss beside its output: the MoE
kinds' load-balancing loss, None for the rest.  A recurrent kind's mixed
step is a ragged forward over the rows' spans.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.models import attention, common, ffn, mla, moe, rglru, xlstm
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import activation

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
    enc_out: Optional[torch.Tensor] = None  # [B, Te, d] (whisper decoder)
    causal: bool = True                   # mask-free attention (encoder: no)
    chunked: bool = False                 # blockwise attention (long T)
    prefix_len: int = 0                   # bidirectional prefix (VLM)


PORTED_KINDS = ("attn", "local", "moe", "mla", "mla_moe", "rglru", "slstm",
                "mlstm", "xattn")
MOE_KINDS = ("moe", "mla_moe")


def check_kind(kind: str) -> None:
    """Raise for a block kind the port does not know."""
    if kind not in PORTED_KINDS:
        raise ValueError(f"unknown block kind {kind}")


def block_init(kind: str, gen: torch.Generator, cfg: ModelConfig) -> Params:
    check_kind(kind)
    d = cfg.d_model
    if kind == "xattn":
        return {"norm1": common.norm_init(d, cfg.norm_type, gen.device),
                "attn": attention.init(gen, cfg),
                "norm_x": common.norm_init(d, cfg.norm_type, gen.device),
                "xattn": attention.init(gen, cfg),
                "norm2": common.norm_init(d, cfg.norm_type, gen.device),
                "ffn": ffn.init(gen, cfg)}
    if kind in ("slstm", "mlstm"):
        cell = (xlstm.slstm_init if kind == "slstm" else xlstm.mlstm_init)
        return {"norm1": common.norm_init(d, cfg.norm_type, gen.device),
                "cell": cell(gen, cfg)}
    ffn_init = moe.init if kind in MOE_KINDS else ffn.init
    if kind in ("mla", "mla_moe", "rglru"):
        mixer = ({"rec": rglru.init(gen, cfg)} if kind == "rglru"
                 else {"attn": mla.init(gen, cfg)})
        return {"norm1": common.norm_init(d, cfg.norm_type, gen.device),
                **mixer,
                "norm2": common.norm_init(d, cfg.norm_type, gen.device),
                "ffn": ffn_init(gen, cfg)}
    p = {"norm1": common.norm_init(d, cfg.norm_type, gen.device),
         "attn": attention.init(gen, cfg)}
    if not cfg.parallel_block:
        p["norm2"] = common.norm_init(d, cfg.norm_type, gen.device)
    p["ffn"] = ffn_init(gen, cfg)
    return p


def _res(x, cache):
    """The residual stream after an add, under a binding: rows over the
    data axes, and the sequence over model in a cache-free (training)
    pass, as between layers; a row-parallel projection's partial sums are
    reduced here (a reduce-scatter, or an all-reduce in a cached step)."""
    return activation.constrain(x, "batch",
                                "seq" if cache is None else None, None)


def _norm(p, cfg, x):
    return common.apply_norm(p, x, cfg.norm_type, cfg.norm_eps)


def _ffn(kind: str, p: Params, cfg: ModelConfig, h: torch.Tensor
         ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The block's FFN on ``h``: (output, the MoE aux loss or None)."""
    if kind in MOE_KINDS:
        return moe.forward(p, cfg, h)
    return ffn.forward(p, cfg, h), None


def block_apply(kind: str, p: Params, cfg: ModelConfig, x: torch.Tensor,
                ctx: BlockCtx, cache: Params | None
                ) -> tuple[torch.Tensor, Params | None, torch.Tensor | None]:
    """Returns (x, cache, aux): aux is the MoE kinds' load-balancing loss,
    None for the other kinds.  The window applies to ``local`` layers
    only."""
    check_kind(kind)
    h = _norm(p["norm1"], cfg, x)
    if kind in ("mla", "mla_moe"):
        return _mla_apply(kind, p, cfg, x, h, ctx, cache)
    if kind == "rglru":
        return _rglru_apply(p, cfg, x, h, ctx, cache) + (None,)
    if kind in ("slstm", "mlstm"):
        return _xlstm_apply(kind, p, cfg, x, h, ctx, cache) + (None,)
    if kind == "xattn":
        return _xattn_apply(p, cfg, x, h, ctx, cache) + (None,)
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
                                     ctx.positions, chunked=ctx.chunked,
                                     prefix_len=ctx.prefix_len,
                                     lengths=ctx.lengths)
    else:
        a = attention.forward(p["attn"], local_cfg, h, mask, ctx.positions,
                              ctx.impl, causal=ctx.causal,
                              chunked=ctx.chunked,
                              prefix_len=ctx.prefix_len)
    if cfg.parallel_block:
        f, aux = _ffn(kind, p["ffn"], cfg, h)
        return _res(x + a + f, cache), cache, aux
    x = _res(x + a, cache)
    f, aux = _ffn(kind, p["ffn"], cfg, _norm(p["norm2"], cfg, x))
    return _res(x + f, cache), cache, aux


def _mla_apply(kind: str, p: Params, cfg: ModelConfig, x: torch.Tensor,
               h: torch.Tensor, ctx: BlockCtx, cache: Params | None
               ) -> tuple[torch.Tensor, Params | None, torch.Tensor | None]:
    """The ``mla`` / ``mla_moe`` kinds: latent attention, then the dense
    or the MoE FFN (never in parallel, as in the JAX package)."""
    if ctx.mode == "mixed":
        a, cache = mla.mixed_step(p["attn"], cfg, h, cache, ctx.pos,
                                  ctx.lengths, ctx.positions, ctx.impl)
    elif ctx.mode == "decode":
        a, cache = mla.decode_step(p["attn"], cfg, h, cache, ctx.pos,
                                   ctx.impl)
    elif cache is not None:
        a, cache = mla.prefill(p["attn"], cfg, h, cache, ctx.mask_full,
                               ctx.positions, chunked=ctx.chunked,
                               prefix_len=ctx.prefix_len,
                               lengths=ctx.lengths)
    else:
        a = mla.forward(p["attn"], cfg, h, ctx.mask_full, ctx.positions,
                        chunked=ctx.chunked, prefix_len=ctx.prefix_len)
    x = _res(x + a, cache)
    f, aux = _ffn(kind, p["ffn"], cfg, _norm(p["norm2"], cfg, x))
    return _res(x + f, cache), cache, aux


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
    x = _res(x + r, cache)
    return _res(x + ffn.forward(p["ffn"], cfg, _norm(p["norm2"], cfg, x)),
                cache), cache


def _xlstm_apply(kind: str, p: Params, cfg: ModelConfig, x: torch.Tensor,
                 h: torch.Tensor, ctx: BlockCtx, cache: Params | None
                 ) -> tuple[torch.Tensor, Params | None]:
    """The ``slstm`` / ``mlstm`` kinds: the cell on the normed input, added
    to the residual (no FFN).  Every mode but decode is a forward, ragged
    over ``ctx.lengths`` where given (a mixed step: the rows' spans)."""
    if kind == "slstm":
        step, fwd = xlstm.slstm_decode, xlstm.slstm_forward
    else:
        step, fwd = xlstm.mlstm_decode, xlstm.mlstm_forward
    if ctx.mode == "decode":
        y, cache = step(p["cell"], cfg, h, cache)
    else:
        y, cache = fwd(p["cell"], cfg, h, cache, lengths=ctx.lengths)
    return _res(x + y, cache), cache


def _cross_kv(p: Params, cfg: ModelConfig, enc_out: torch.Tensor):
    k = attention._split_heads(common.dense(p["wk"], enc_out),
                               cfg.num_kv_heads)
    v = attention._split_heads(common.dense(p["wv"], enc_out),
                               cfg.num_kv_heads)
    return k, v


def _cross_attend(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bidirectional attention of ``x`` over the encoder's K/V: the plain
    path always, as in JAX (which passes ``"ref"`` here)."""
    q = attention._split_heads(common.dense(p["wq"], x), cfg.num_heads)
    out = attention._sdpa(q, k, v, None, cfg.head_dim ** -0.5, "ref",
                          causal=False)
    return common.dense(p["wo"], attention._merge_heads(out).to(x.dtype))


def _xattn_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 h: torch.Tensor, ctx: BlockCtx, cache: Params | None
                 ) -> tuple[torch.Tensor, Params | None]:
    """The ``xattn`` kind (whisper's decoder block): causal self-attention
    over k / v, cross-attention over the encoder output, then the FFN.
    Prefill fills the cross-KV (xk, xv) once from ``ctx.enc_out``; decode
    reads it back.  The cache is updated in place."""
    if ctx.mode == "decode":
        a, _ = attention.decode_step(p["attn"], cfg, h,
                                     {"k": cache["k"], "v": cache["v"]},
                                     ctx.pos, ctx.impl)
        c = _cross_attend(p["xattn"], cfg, _norm(p["norm_x"], cfg, x + a),
                          cache["xk"], cache["xv"])
    else:
        if cache is not None:
            a, _ = attention.prefill(p["attn"], cfg, h,
                                     {"k": cache["k"], "v": cache["v"]},
                                     ctx.mask_full, ctx.positions,
                                     chunked=ctx.chunked)
            xk, xv = _cross_kv(p["xattn"], cfg, ctx.enc_out)
            cache["xk"].copy_(xk.to(cache["xk"].dtype))
            cache["xv"].copy_(xv.to(cache["xv"].dtype))
            xk, xv = cache["xk"], cache["xv"]
        else:
            a = attention.forward(p["attn"], cfg, h, ctx.mask_full,
                                  ctx.positions, ctx.impl,
                                  chunked=ctx.chunked)
            xk, xv = _cross_kv(p["xattn"], cfg, ctx.enc_out)
        hx = _norm(p["norm_x"], cfg, x + a)
        c = _cross_attend(p["xattn"], cfg, hx, xk.to(x.dtype),
                          xv.to(x.dtype))
    x = _res(x + a + c, cache)
    return _res(x + ffn.forward(p["ffn"], cfg, _norm(p["norm2"], cfg, x)),
                cache), cache
