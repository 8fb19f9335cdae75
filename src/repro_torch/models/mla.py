"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

The KV state is a shared latent ``c_kv`` (rank ``kv_lora_rank``) plus a
small decoupled-RoPE key shared across heads: the cache stores
[B, S, r + rope_dim] instead of [B, S, 2·H·head_dim].

Decode and the mixed step use the weight-absorption identity
q_nopeᵀ·(c_kv·W_uk) = (q_nope·W_ukᵀ)ᵀ·c_kv: attention runs against the
compressed cache with no per-step decompression.  The absorbed
contractions are float32, as in the JAX package.  On a paged latent cache
they run in the port's MLA kernels through ``kernels.ops``
(``paged_mla_chunk`` for the mixed step, ``paged_mla_decode`` for decode,
their ``_quant`` counterparts over int8 / fp8 pools); on a dense latent
cache and in the full-sequence path they are plain matmuls, which the JAX
package also leaves outside any Pallas kernel.

Caches are updated in place: the functions return the same layer dict
whose tensors they wrote.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models import attention, common
from repro_torch.models import cache as cache_mod
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import activation

Params = Any

# Every paged-MLA layout; _q8 / _fp8 carry a quantized latent pool plus a
# per-row f32 scale pool and route to the _quant kernels.
_PAGED_MLA = ("paged_mla", "paged_mla_q8", "paged_mla_fp8")


def init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    return {
        "w_dkv": common.dense_init(gen, d, m.kv_lora_rank),
        "w_kr": common.dense_init(gen, d, m.rope_head_dim),
        "w_uk": common.dense_init(gen, m.kv_lora_rank, h * m.nope_head_dim),
        "w_uv": common.dense_init(gen, m.kv_lora_rank, h * m.v_head_dim),
        "w_q": common.dense_init(gen, d,
                                 h * (m.nope_head_dim + m.rope_head_dim)),
        "w_o": common.dense_init(gen, h * m.v_head_dim, d),
        "kv_norm": common.norm_init(m.kv_lora_rank, "rmsnorm", gen.device),
    }


def _scale(cfg: ModelConfig) -> float:
    return (cfg.mla.nope_head_dim + cfg.mla.rope_head_dim) ** -0.5


def _queries(p, cfg, x, positions):
    """(q_nope, q_rope), each [B, H, T, *], RoPE applied to q_rope."""
    m = cfg.mla
    b, t, _ = x.shape
    q = activation.split_last(common.dense(p["w_q"], x), cfg.num_heads)
    q = q.transpose(1, 2)                                       # [B,H,T,*]
    q_nope, q_rope = q.split([m.nope_head_dim, m.rope_head_dim], dim=-1)
    return q_nope, common.apply_rope(q_rope, positions, cfg.rope_theta)


def _latents(p, cfg, x, positions):
    """(ckv [B, T, r] normed, krope [B, T, rd] with RoPE)."""
    ckv = common.apply_norm(p["kv_norm"], common.dense(p["w_dkv"], x),
                            "rmsnorm", cfg.norm_eps)
    krope = common.apply_rope(common.dense(p["w_kr"], x)[:, None],
                              positions, cfg.rope_theta)[:, 0]
    return ckv, krope


def _absorb_q(p, cfg, q_nope):
    """q_abs[b,h,c,r] = Σ_n q_nope · W_uk[r, h, n], float32."""
    m = cfg.mla
    w_uk = p["w_uk"]["w"].reshape(m.kv_lora_rank, cfg.num_heads,
                                  m.nope_head_dim)
    return torch.einsum("bhcn,rhn->bhcr", q_nope.float(), w_uk.float())


def _out(p, cfg, ctx, dtype):
    """Latent context [B, H, C, r] float32 -> W_uv -> W_o, [B, C, d]."""
    m = cfg.mla
    b, h, c, _ = ctx.shape
    w_uv = p["w_uv"]["w"].reshape(m.kv_lora_rank, h, m.v_head_dim)
    out = torch.einsum("bhcr,rhd->bhcd", ctx, w_uv.float())
    out = out.transpose(1, 2).reshape(b, c, h * m.v_head_dim)
    return common.dense(p["w_o"], out.to(dtype))


def _latent_rows(ckv, krope, dp):
    """concat([ckv; krope]) zero-padded to the pool width Dp (on
    ``DTensor``s, on each rank's rows with the features whole)."""
    def rows(c, k):
        lat = torch.cat([c, k], dim=-1)
        return F.pad(lat, (0, dp - lat.shape[-1]))
    return activation.last_whole(rows, ckv, krope)


def forward(p: Params, cfg: ModelConfig, x: torch.Tensor,
            mask: Optional[torch.Tensor], positions: torch.Tensor,
            chunked: bool = False, prefix_len: int = 0) -> torch.Tensor:
    """Full-sequence path (expanded keys and values).  The two-term MLA
    logits are one contraction over concat([nope; rope]), so the shared
    ``attention._sdpa`` applies, its blockwise path (``chunked``, values of
    ``v_head_dim`` beside keys of nope + rope) included."""
    m = cfg.mla
    b, t, _ = x.shape
    h = cfg.num_heads
    q_nope, q_rope = _queries(p, cfg, x, positions)
    ckv, krope = _latents(p, cfg, x, positions)
    k_nope = activation.split_last(activation.matmul(
        ckv, p["w_uk"]["w"].to(ckv.dtype)), h).transpose(1, 2)
    v = activation.split_last(activation.matmul(
        ckv, p["w_uv"]["w"].to(ckv.dtype)), h).transpose(1, 2)
    qc = torch.cat([q_nope, q_rope], dim=-1)
    kc = torch.cat([k_nope, krope[:, None].expand(b, h, t, m.rope_head_dim)
                    .to(k_nope.dtype)], dim=-1)
    out = attention._sdpa(qc, kc, v, mask, _scale(cfg), chunked=chunked,
                          prefix_len=prefix_len)
    out = out.transpose(1, 2).reshape(b, t, h * m.v_head_dim)
    return common.dense(p["w_o"], out.to(x.dtype))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, paged: bool = False,
               page_size: int = 64, num_pages: int | None = None,
               kv_quant: str = "off", device=None) -> Params:
    """Dense latent cache [B, S, r] + [B, S, rd], or a paged latent pool
    [P, page_size, pad128(r + rd)] with per-row block tables."""
    from repro_torch import resolve_device
    return cache_mod.spec_for("mla", cfg, batch, max_len, dtype, paged=paged,
                              page_size=page_size, num_pages=num_pages,
                              kv_quant=kv_quant).init(resolve_device(device))


def _paged_latent_write(cache: Params, ckv: torch.Tensor,
                        krope: torch.Tensor,
                        lengths: Optional[torch.Tensor]) -> Params:
    """Scatter a prompt's latent rows ([B, T, r] / [B, T, rd]) into pages,
    in place, with the MHA prefill's drop rule (``attention._prefill_slots``:
    -1 entries, past the table, past a ragged row's length)."""
    pool = cache["latent_pages"]
    _, ps, dp = pool.shape
    if cache_mod.is_dtensor(pool):
        # Every row into each rank's feature slice of the shared pool.
        if "latent_scales" in cache:
            kops._no_sharded_pool("paged MLA prefill", pool)
        pg, slot, keep = attention._prefill_slots(
            kops._full(cache["block_tables"]), ckv.shape[1], ps,
            kops._full(lengths))
        rows = kops.like_pool(_latent_rows(ckv, krope, dp), pool, -1)
        local = pool.to_local()
        local[pg[keep], slot[keep]] = rows[keep].to(local.dtype)
        return cache
    pg, slot, keep = attention._prefill_slots(cache["block_tables"],
                                              ckv.shape[1], ps, lengths)
    rows = _latent_rows(ckv, krope, dp)[keep]                    # [N, Dp]
    if "latent_scales" in cache:
        rows, srows = kref.quantize_rows(rows, pool.dtype)
        cache["latent_scales"][pg[keep], slot[keep]] = srows
    pool[pg[keep], slot[keep]] = rows.to(pool.dtype)
    return cache


def prefill(p: Params, cfg: ModelConfig, x: torch.Tensor, cache: Params,
            mask: Optional[torch.Tensor], positions: torch.Tensor,
            chunked: bool = False, prefix_len: int = 0,
            lengths: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, Params]:
    """Full-prompt forward that also fills cache positions [0, T).

    ``lengths`` (i32[B]) admits a ragged right-padded batch: cache writes
    beyond each row's length are dropped, so rows with ``lengths[b] == 0``
    keep their cache bit for bit.  ``chunked`` and ``prefix_len`` as
    ``forward``."""
    y = forward(p, cfg, x, mask, positions, chunked=chunked,
                prefix_len=prefix_len)
    ckv, krope = _latents(p, cfg, x, positions)
    layout = cache_mod.layout_of(cache)
    if layout in _PAGED_MLA:
        return y, _paged_latent_write(cache, ckv, krope, lengths)
    t = x.shape[1]
    for name, new in (("ckv", ckv), ("krope", krope)):
        if lengths is not None:
            dst = cache[name][:, :t]
            keep = (torch.arange(t, device=x.device)[None, :]
                    < lengths.to(x.device)[:, None])
            new = torch.where(keep[..., None], new.to(dst.dtype), dst)
        cache_mod.put_prefix(cache[name], 1, new)
    return y, cache


def mixed_step(p: Params, cfg: ModelConfig, x: torch.Tensor, cache: Params,
               start: torch.Tensor, span: torch.Tensor,
               positions: torch.Tensor, impl: str = "kernel"
               ) -> tuple[torch.Tensor, Params]:
    """Per-row query spans against the compressed cache (mixed serve step).

    x: [B, C, d]; start/span: i32[B]; positions: i32[B, C].  The absorbed
    contractions of ``decode_step`` for every query of the span; the
    span's latent rows are written before the attend (causal within the
    span)."""
    b, c, _ = x.shape
    q_nope, q_rope = _queries(p, cfg, x, positions)               # [B,H,C,*]
    ckv_t, krope_t = _latents(p, cfg, x, positions)               # [B,C,*]
    q_abs = _absorb_q(p, cfg, q_nope)
    scale = _scale(cfg)
    layout = cache_mod.layout_of(cache)
    if layout in _PAGED_MLA:
        pool = cache["latent_pages"]
        lat_new = _latent_rows(ckv_t, krope_t, pool.shape[-1])
        if layout != "paged_mla":
            ctx = kops.paged_mla_chunk_quant(
                q_abs, q_rope, pool, cache["latent_scales"],
                cache["block_tables"], start, span, lat_new, scale=scale,
                impl=impl)[0]
        else:
            ctx = kops.paged_mla_chunk(
                q_abs, q_rope, pool, cache["block_tables"], start, span,
                lat_new, scale=scale, impl=impl)[0]
        return _out(p, cfg, ctx, x.dtype), cache
    # Dense latent cache: write the span via a position gather (slot s
    # takes span token s - start when that offset lies in [0, span)), then
    # the same absorbed contractions over the whole stream.
    s = cache["ckv"].shape[1]
    start = start.to(x.device).long()
    span = span.to(x.device).long()
    pidx = torch.arange(s, device=x.device)
    off = pidx[None, :] - start[:, None]                          # [B, S]
    wmask = ((off >= 0) & (off < span[:, None]))[..., None]
    gidx = off.clamp(0, c - 1)[..., None]
    for name, new in (("ckv", ckv_t), ("krope", krope_t)):
        dst = cache[name]
        new_in = new.to(dst.dtype).gather(1, gidx.expand(b, s, new.shape[-1]))
        dst.copy_(torch.where(wmask, new_in, dst))
    ckv = cache["ckv"].float()
    logits = (torch.einsum("bhcr,bsr->bhcs", q_abs, ckv)
              + torch.einsum("bhcr,bsr->bhcs", q_rope.float(),
                             cache["krope"].float())) * scale
    valid = pidx[None, None, :] <= positions[:, :, None]          # [B, C, S]
    logits = logits.masked_fill(~valid[:, None], float("-inf"))
    ctx = torch.einsum("bhcs,bsr->bhcr", torch.softmax(logits, dim=-1), ckv)
    return _out(p, cfg, ctx, x.dtype), cache


def decode_step(p: Params, cfg: ModelConfig, x: torch.Tensor, cache: Params,
                pos: torch.Tensor, impl: str = "kernel"
                ) -> tuple[torch.Tensor, Params]:
    """Absorbed-weight decode against the compressed cache.  x: [B, 1, d];
    pos: i32[B] tokens already cached."""
    b = x.shape[0]
    pos = pos.to(x.device)
    q_nope, q_rope = _queries(p, cfg, x, pos[:, None])            # [B,H,1,*]
    ckv_t, krope_t = _latents(p, cfg, x, pos[:, None])            # [B,1,*]
    q_abs = _absorb_q(p, cfg, q_nope)
    scale = _scale(cfg)
    layout = cache_mod.layout_of(cache)
    if layout in _PAGED_MLA:
        # The ops wrappers clamp pos to the table's capacity: past it the
        # last slot is rewritten instead of the table read out of bounds.
        pool = cache["latent_pages"]
        lat_new = _latent_rows(ckv_t[:, 0], krope_t[:, 0], pool.shape[-1])
        if layout != "paged_mla":
            ctx = kops.paged_mla_decode_quant(
                q_abs[:, :, 0], q_rope[:, :, 0], pool,
                cache["latent_scales"], cache["block_tables"], pos, lat_new,
                scale=scale, impl=impl)[0]
        else:
            ctx = kops.paged_mla_decode(
                q_abs[:, :, 0], q_rope[:, :, 0], pool,
                cache["block_tables"], pos, lat_new, scale=scale,
                impl=impl)[0]
        return _out(p, cfg, ctx[:, :, None], x.dtype), cache
    # Dense latent cache: write slot pos (dropped past the cache, as JAX's
    # one-hot write), then attend over positions <= pos.
    s = cache["ckv"].shape[1]
    slot = pos.clamp(max=s - 1).long()
    for name, new in (("ckv", ckv_t), ("krope", krope_t)):
        cache_mod.put_slot(cache[name], 1, slot, new[:, 0], keep=pos < s)
    ckv = cache["ckv"].float()
    logits = (torch.einsum("bhr,bsr->bhs", q_abs[:, :, 0], ckv)
              + torch.einsum("bhr,bsr->bhs", q_rope[:, :, 0].float(),
                             cache["krope"].float())) * scale
    valid = torch.arange(s, device=x.device)[None, :] <= pos[:, None]
    logits = logits.masked_fill(~valid[:, None, :], float("-inf"))
    ctx = torch.einsum("bhs,bsr->bhr", torch.softmax(logits, dim=-1), ckv)
    return _out(p, cfg, ctx[:, :, None], x.dtype), cache
