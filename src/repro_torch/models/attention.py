"""GQA attention with optional sliding window and RoPE: the full-sequence
path, prompt prefill into a cache, the single-token decode step and the
token-budget mixed step, over a dense or a paged KV cache.  The window
(the ``local`` kind) reaches prefill through the caller's mask, the mixed
step through its masks, and decode through ``decode_attention`` where the
cache holds no more than the window, else a masked einsum.

The full-sequence path without a mask (the whisper encoder) runs on
``flash_attention``.  The decode and mixed steps run the port's attention
kernels through ``kernels.ops``: ``paged_chunk_attention`` (mixed step,
paged cache), ``paged_decode_attention`` (decode, paged cache), their
``_quant`` counterparts over int8 / fp8 pools with row scales
(``paged_mha_q8`` and ``paged_mha_fp8`` caches) and ``decode_attention``
(decode, dense cache).
``impl="kernel"`` lets the tensor's device choose (the Hopper kernel on a
CUDA tensor, the plain version on a CPU tensor); ``impl="ref"`` takes the
plain version everywhere.

Caches are updated in place: the functions return the same layer dict
whose tensors they wrote.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models import cache as cache_mod
from repro_torch.models import common
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import activation

Params = Any


def init(gen: torch.Generator, cfg: ModelConfig,
         d_model: int | None = None) -> Params:
    d = d_model or cfg.d_model
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": common.dense_init(gen, d, hq * hd, cfg.use_bias),
        "wk": common.dense_init(gen, d, hkv * hd, cfg.use_bias),
        "wv": common.dense_init(gen, d, hkv * hd, cfg.use_bias),
        "wo": common.dense_init(gen, hq * hd, d, cfg.use_bias),
    }
    if cfg.qk_norm:
        p["q_norm"] = common.norm_init(hd, "rmsnorm", gen.device)
        p["k_norm"] = common.norm_init(hd, "rmsnorm", gen.device)
    return p


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    return activation.split_last(x, n_heads).transpose(1, 2)  # [B,H,T,D]


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def _qkv(p: Params, cfg: ModelConfig, x: torch.Tensor,
         positions: torch.Tensor):
    q = _split_heads(common.dense(p["wq"], x), cfg.num_heads)
    k = _split_heads(common.dense(p["wk"], x), cfg.num_kv_heads)
    v = _split_heads(common.dense(p["wv"], x), cfg.num_kv_heads)
    if cfg.qk_norm:
        q = common.apply_norm(p["q_norm"], q, "rmsnorm", cfg.norm_eps)
        k = common.apply_norm(p["k_norm"], k, "rmsnorm", cfg.norm_eps)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _block_mask(rows: torch.Tensor, cols: torch.Tensor, *, tk_true: int,
                causal: bool, window, prefix_len: int) -> torch.Tensor:
    """The mask of a (rows × cols) tile of absolute query and key
    positions, built where it is used: ``common.make_mask``'s rule."""
    r = rows[:, None]
    c = cols[None, :]
    mask = c < tk_true
    if causal:
        cm = c <= r
        if prefix_len > 0:
            cm = cm | (c < prefix_len)
        mask = mask & cm
    if window is not None:
        wm = c >= r - window + 1
        if prefix_len > 0:
            wm = wm | (c < prefix_len)
        mask = mask & wm
    return mask


def _sdpa_chunked(q, k, v, scale, *, causal: bool = True, window=None,
                  prefix_len: int = 0, chunk: int = 1024) -> torch.Tensor:
    """Blockwise online-softmax attention, the path of prompts past
    ``lm.CHUNKED_THRESHOLD``: a loop over KV chunks of ``chunk`` keys
    carries (m, l, acc) in float32, so no [Tq, Tk] mask or score tensor
    exists (at 32k they would be GiB a head row).  Plain PyTorch, as JAX's
    is plain XLA (a ``lax.scan``).  q: [B, Hq, Tq, D]; k: [B, Hkv, Tk, D];
    v: [B, Hkv, Tk, Dv] (Dv may differ from D: MLA).  Query rows are
    end-aligned with the keys; the output is in q's dtype."""
    b, hq, tq, _ = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    group = hq // hkv
    dev = q.device
    rows = torch.arange(tq, device=dev) + (tk - tq)
    qf = q.float()
    m = torch.full((b, hq, tq), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hq, tq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hq, tq, v.shape[-1]), dtype=torch.float32,
                      device=dev)
    for start in range(0, tk, chunk):
        kb = activation.repeat_kv(k[:, :, start:start + chunk],
                                  group).float()
        vb = activation.repeat_kv(v[:, :, start:start + chunk],
                                  group).float()
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale
        cols = start + torch.arange(kb.shape[2], device=dev)
        mask = _block_mask(rows, cols, tk_true=tk, causal=causal,
                           window=window, prefix_len=prefix_len)
        s = s.masked_fill(~mask, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p, vb)
        m = m_new
    return (acc / l.clamp(min=1e-30)[..., None]).to(q.dtype)


def _sdpa(q, k, v, mask, scale, impl: str = "ref", window=None,
          causal: bool = True, chunked: bool = False, prefix_len: int = 0):
    """q: [B,H,Tq,D]; k,v: [B,Hkv,Tk,D]; mask: bool[Tq,Tk] / [B,Tq,Tk] /
    None.  ``chunked`` (a prompt past ``lm.CHUNKED_THRESHOLD``, which has
    no mask either): ``_sdpa_chunked`` with ``causal``, ``window`` and
    ``prefix_len``, tested first as JAX does.  Without a mask and unless
    ``impl="ref"``, the ``flash_attention`` kernel's route (JAX's
    ``impl="pallas"`` route), with ``causal`` and ``window``.  Otherwise
    plain matmul + softmax as the JAX reference's ``_sdpa``: logits in
    float32, probabilities cast back to q's dtype, and no mask at all where
    ``mask`` is None.  A 3-D mask carries per-row validity (ragged
    prefill); rows with no valid key give NaN, which callers discard."""
    if chunked:
        if cache_mod.is_dtensor(q):
            # Each rank's rows and heads, every key: the KV heads repeated
            # for the rank's query heads once, not a chunk at a time.
            group = q.shape[1] // k.shape[1]
            return activation.by_heads(
                lambda q, k, v, _: _sdpa_chunked(
                    q, k, v, scale, causal=causal, window=window,
                    prefix_len=prefix_len),
                q, activation.repeat_kv(k, group),
                activation.repeat_kv(v, group))
        return _sdpa_chunked(q, k, v, scale, causal=causal, window=window,
                             prefix_len=prefix_len)
    if impl != "ref" and mask is None:
        return kops.flash_attention(q, k, v, causal=causal, scale=scale,
                                    window=window, impl=impl)
    group = q.shape[1] // k.shape[1]

    def attend(q, kb, vb, mask):
        logits = torch.matmul(q.float(), kb.float().transpose(-1, -2)) * scale
        if mask is not None:
            mask_b = mask[:, None] if mask.dim() == 3 else mask[None, None]
            logits = logits.masked_fill(~mask_b, float("-inf"))
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        # JAX's einsum promotes mixed operands (a float32 query over a bf16
        # cross-KV cache): so does this product.
        dt = torch.promote_types(probs.dtype, vb.dtype)
        return torch.matmul(probs.to(dt), vb.to(dt))

    return activation.by_heads(attend, q, activation.repeat_kv(k, group),
                               activation.repeat_kv(v, group), mask=mask)


def forward(p: Params, cfg: ModelConfig, x: torch.Tensor,
            mask: Optional[torch.Tensor], positions: torch.Tensor,
            impl: str = "kernel", causal: bool = True,
            chunked: bool = False, prefix_len: int = 0) -> torch.Tensor:
    """Full-sequence path (prefill without a cache).  With no mask (the
    whisper encoder) the attention runs on ``flash_attention`` unless
    ``impl="ref"``; ``causal=False`` keeps it bidirectional.  ``chunked``:
    the blockwise path, with the ``prefix_len`` keys a bidirectional
    prefix."""
    q, k, v = _qkv(p, cfg, x, positions)
    out = _sdpa(q, k, v, mask, cfg.head_dim ** -0.5, impl,
                window=cfg.window, causal=causal, chunked=chunked,
                prefix_len=prefix_len)
    return common.dense(p["wo"], _merge_heads(out))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, paged: bool = False,
               page_size: int = 64, num_pages: int | None = None,
               device=None) -> Params:
    """Dense cache [B, Hkv, S, D], or a paged pool + per-row block tables
    (``-1`` = unallocated).  Shapes come from the CacheSpec registry."""
    from repro_torch import resolve_device
    return cache_mod.spec_for("attn", cfg, batch, max_len, dtype,
                              paged=paged, page_size=page_size,
                              num_pages=num_pages).init(resolve_device(device))


def default_block_tables(batch: int, max_len: int, page_size: int,
                         device=None) -> torch.Tensor:
    """Identity mapping — row b owns contiguous pages [b*maxp, (b+1)*maxp)."""
    maxp = -(-max_len // page_size)
    return torch.arange(batch * maxp, dtype=torch.int32,
                        device=device).reshape(batch, maxp)


def _prefill_slots(bt: torch.Tensor, t: int, ps: int,
                   lengths: Optional[torch.Tensor]):
    """Pages, slots and keep mask, each [B, T], of a prompt's cache writes
    through the block tables ``bt``.  Dropped: -1 table entries, positions
    past the table, and positions >= lengths[b] (right-padding of a ragged
    batch), so a prefill touches only the prefilled rows' pages."""
    maxp = bt.shape[1]
    tpos = torch.arange(t, device=bt.device)
    pg = bt.long()[:, (tpos // ps).clamp(max=maxp - 1)]
    keep = (pg >= 0) & (tpos[None, :] < maxp * ps)
    if lengths is not None:
        keep &= tpos[None, :] < lengths.to(bt.device)[:, None]
    return pg, (tpos % ps)[None, :].expand_as(pg), keep


def _paged_prefill_write(cache: Params, k: torch.Tensor, v: torch.Tensor,
                         lengths: Optional[torch.Tensor]) -> Params:
    """Scatter a prompt's K/V ([B, Hkv, T, D]) into the row's pages, in
    place, through ``_prefill_slots``."""
    quantized = "k_scales" in cache
    if cache_mod.is_dtensor(cache["k_pages"]):
        # Every row into each rank's head shard of the shared pools.
        if quantized:
            kops._no_sharded_pool("paged prefill", cache["k_pages"])
        pg, slot, keep = _prefill_slots(
            kops._full(cache["block_tables"]), k.shape[2],
            cache["k_pages"].shape[2], kops._full(lengths))
        for name, new in (("k_pages", k), ("v_pages", v)):
            rows = kops.like_pool(new, cache[name], 1).transpose(1, 2)
            local = cache[name].to_local()
            local[pg[keep], :, slot[keep], :] = rows[keep].to(local.dtype)
        return cache
    pg, slot, keep = _prefill_slots(cache["block_tables"], k.shape[2],
                                    cache["k_pages"].shape[2], lengths)
    for name, new in (("k_pages", k), ("v_pages", v)):
        pool = cache[name]
        rows = new.transpose(1, 2)[keep]                    # [N, Hkv, D]
        if quantized:
            # Per-row scales ride beside the values, written through the
            # same drop rule, so untouched rows stay bit for bit.
            rows, srows = kref.quantize_rows(rows, pool.dtype)
            cache[cache_mod.SCALE_LEAF[name]][pg[keep], :, slot[keep]] = srows
        pool[pg[keep], :, slot[keep], :] = rows.to(pool.dtype)
    return cache


def prefill(p: Params, cfg: ModelConfig, x: torch.Tensor, cache: Params,
            mask: Optional[torch.Tensor], positions: torch.Tensor,
            chunked: bool = False, prefix_len: int = 0,
            lengths: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, Params]:
    """Full-prompt forward that also fills cache positions [0, T).

    ``lengths`` (i32[B]) marks a ragged right-padded batch: attention over
    padding is masked by the caller's 3-D mask and cache writes beyond each
    row's length are dropped, so rows with ``lengths[b] == 0`` keep their
    cache bit for bit.  ``chunked`` (no mask): the blockwise path, with
    the ``prefix_len`` keys a bidirectional prefix.
    """
    q, k, v = _qkv(p, cfg, x, positions)
    out = _sdpa(q, k, v, mask, cfg.head_dim ** -0.5, window=cfg.window,
                chunked=chunked, prefix_len=prefix_len)
    proj = common.dense(p["wo"], _merge_heads(out))
    layout = cache_mod.layout_of(cache)
    if layout in cache_mod.PAGED_LAYOUTS:
        return proj, _paged_prefill_write(cache, k, v, lengths)
    if layout != "dense":
        raise NotImplementedError(f"prefill into a {layout} cache")
    t = x.shape[1]
    s = cache["k"].shape[2]
    if t <= s:
        for name, new in (("k", k), ("v", v)):
            if lengths is not None:
                dst = cache[name][:, :, :t]
                keep = (torch.arange(t, device=x.device)[None, :]
                        < lengths.to(x.device)[:, None])
                new = torch.where(keep[:, None, :, None], new.to(dst.dtype),
                                  dst)
            cache_mod.put_prefix(cache[name], 2, new)
        return proj, cache
    if lengths is not None:
        raise NotImplementedError(
            "ragged prefill into a ring cache shorter than the padded "
            "prompt is unsupported — size the ring (window) >= the prompt "
            "bucket, or use a paged/dense cache")
    # Ring cache shorter than the prompt: slot s holds the LAST token with
    # absolute position ≡ s (mod S).
    sl = torch.arange(s, device=x.device)
    p_last = (t - 1) - ((t - 1 - sl) % s)
    cache["k"].copy_(k[:, :, p_last].to(cache["k"].dtype))
    cache["v"].copy_(v[:, :, p_last].to(cache["v"].dtype))
    return proj, cache


def _wrong_layout(layout) -> ValueError:
    return ValueError(
        f"the attn kind runs on dense and paged_mha caches, not on a "
        f"{layout!r} cache")


def _paged_attend(float_op, quant_op, cache: Params, q, idx, k, v, **kw):
    """Fused write + block-table walk over a paged cache: ``float_op`` on
    float pools, ``quant_op`` (the row scales beside the pools) on int8 /
    fp8 pools.  ``idx`` is (pos,) or (start, span).  Returns the output."""
    if "k_scales" in cache:
        return quant_op(q, cache["k_pages"], cache["k_scales"],
                        cache["v_pages"], cache["v_scales"],
                        cache["block_tables"], *idx, k, v, **kw)[0]
    return float_op(q, cache["k_pages"], cache["v_pages"],
                    cache["block_tables"], *idx, k, v, **kw)[0]


def mixed_step(p: Params, cfg: ModelConfig, x: torch.Tensor, cache: Params,
               start: torch.Tensor, span: torch.Tensor,
               positions: torch.Tensor, impl: str = "kernel"
               ) -> tuple[torch.Tensor, Params]:
    """Per-row query spans against the cache (the mixed serve step).

    x: [B, C, D]; start: i32[B] tokens already cached per row; span: i32[B]
    valid new tokens in [0, C]; positions: i32[B, C] absolute positions.
    The span's K/V is written into the cache *before* the attend, so query
    j sees the whole cached prefix plus the span's keys up to itself —
    span 1 is a decode step, span C a prompt chunk, span 0 an idle row
    whose cache is untouched (output garbage).
    """
    b, c, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    scale = cfg.head_dim ** -0.5
    layout = cache_mod.layout_of(cache)
    if layout in cache_mod.PAGED_LAYOUTS:
        out = _paged_attend(kops.paged_chunk_attention,
                            kops.paged_chunk_attention_quant, cache, q,
                            (start, span), k, v, scale=scale,
                            window=cfg.window, impl=impl)
        return common.dense(p["wo"], _merge_heads(out).to(x.dtype)), cache
    if layout != "dense":
        raise _wrong_layout(layout)
    # Dense cache: no ring wrap (S >= start + span).  Write the span via a
    # position gather (slot s takes span token s - start when that offset
    # lies in [0, span)), then attend with the paged oracle's masks.
    s = cache["k"].shape[2]
    start = start.to(x.device).long()
    span = span.to(x.device).long()
    pidx = torch.arange(s, device=x.device)
    off = pidx[None, :] - start[:, None]                          # [B, S]
    wmask = ((off >= 0) & (off < span[:, None]))[:, None, :, None]
    gidx = off.clamp(0, c - 1)[:, None, :, None]
    for name, new in (("k", k), ("v", v)):
        dst = cache[name]
        new_in = new.to(dst.dtype).gather(
            2, gidx.expand(b, new.shape[1], s, new.shape[3]))
        dst.copy_(torch.where(wmask, new_in, dst))
    group = cfg.num_heads // cfg.num_kv_heads
    kb = activation.repeat_kv(cache["k"], group).float()
    vb = activation.repeat_kv(cache["v"], group).float()
    logits = torch.einsum("bhcd,bhsd->bhcs", q.float(), kb) * scale
    valid = pidx[None, None, :] <= positions[:, :, None]          # [B, C, S]
    if cfg.window is not None:
        valid &= pidx[None, None, :] > (positions[:, :, None] - cfg.window)
    logits = logits.masked_fill(~valid[:, None], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhcs,bhsd->bhcd", probs, vb).to(x.dtype)
    return common.dense(p["wo"], _merge_heads(out)), cache


def decode_step(p: Params, cfg: ModelConfig, x: torch.Tensor, cache: Params,
                pos: torch.Tensor, impl: str = "kernel"
                ) -> tuple[torch.Tensor, Params]:
    """One-token step.  x: [B, 1, D]; pos: i32[B] tokens already cached."""
    b = x.shape[0]
    pos = pos.to(x.device)
    q, k, v = _qkv(p, cfg, x, pos[:, None])
    scale = cfg.head_dim ** -0.5
    layout = cache_mod.layout_of(cache)
    if layout in cache_mod.PAGED_LAYOUTS:
        # The ops wrappers clamp pos to the table's capacity: past it the
        # last slot is rewritten (defined, still wrong output — callers
        # bound generation) instead of an out-of-bounds table read
        # corrupting a live page.
        out = _paged_attend(kops.paged_decode_attention,
                            kops.paged_decode_attention_quant, cache,
                            q[:, :, 0], (pos,), k[:, :, 0], v[:, :, 0],
                            scale=scale, window=cfg.window, impl=impl)
        out = out.reshape(b, 1, cfg.num_heads * cfg.head_dim).to(x.dtype)
        return common.dense(p["wo"], out), cache
    if layout != "dense":
        raise _wrong_layout(layout)
    # Ring indexing: token at absolute position p lives at slot p % S (the
    # identity for unbounded caches).
    s = cache["k"].shape[2]
    slot = (pos % s).long()
    # The new token's K/V resharded while tiny, under a binding.
    k_tok = activation.constrain(k[:, :, 0], "batch", None, None)
    v_tok = activation.constrain(v[:, :, 0], "batch", None, None)
    cache_mod.put_slot(cache["k"], 2, slot, k_tok)
    cache_mod.put_slot(cache["v"], 2, slot, v_tok)
    kv_len = (pos + 1).clamp(max=s)
    if cfg.window is None or s <= cfg.window:
        # No window, or the cache holds no more than the window (a ring
        # cache, or max_len <= window): the kernel's causal walk is exact.
        out = kops.decode_attention(q[:, :, 0], cache["k"], cache["v"],
                                    kv_len, scale=scale, impl=impl)
    else:
        out = _windowed_decode(cfg, q[:, :, 0], cache, pos, kv_len, scale)
    out = out.reshape(b, 1, cfg.num_heads * cfg.head_dim).to(x.dtype)
    return common.dense(p["wo"], out), cache


def _windowed_decode(cfg: ModelConfig, q: torch.Tensor, cache: Params,
                     pos: torch.Tensor, kv_len: torch.Tensor, scale: float
                     ) -> torch.Tensor:
    """Sliding-window decode over an unbounded dense cache (S > window):
    the dense kernel has no window, so this is JAX's masked grouped einsum
    (logits in float32, probabilities in q's dtype).  q: [B, Hq, D]."""
    b, s = q.shape[0], cache["k"].shape[2]
    group = cfg.num_heads // cfg.num_kv_heads
    qg = q.reshape(b, cfg.num_kv_heads, group, cfg.head_dim)
    logits = torch.einsum("bkgd,bksd->bkgs", qg.float(),
                          cache["k"].float()) * scale
    slots = torch.arange(s, device=q.device)[None, :]
    valid = ((slots < kv_len[:, None])
             & (slots > (pos[:, None] - cfg.window)))       # [B, S]
    logits = logits.masked_fill(~valid[:, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgs,bksd->bkgd", probs.float(), cache["v"].float())
    return out.to(q.dtype).reshape(b, cfg.num_heads, cfg.head_dim)
