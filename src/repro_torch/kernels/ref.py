"""Plain PyTorch versions of the kernels (the correctness contract): the
attention kernels over float and quantized pools, MHA and MLA, blocked
(flash) attention over whole sequences, the diagonal linear recurrence of
the RG-LRU, the cross-pool page transfer of disaggregated serving, and the
two register-bank operations of replica sync: the LWW join of two banks and
the LWW-guarded scatter of a delta buffer into a bank; and the plain
pieces of speculative decoding's verify step (greedy acceptance, span
snapshot and rollback), which have no kernel in either package.

Each function is the mathematical definition with no tiling, line for line
in semantics with ``repro.kernels.ref``: the CPU path of every wrapper in
``ops.py`` runs these, and on the card each CUDA kernel is held against
them.  Accumulation is float32; the MHA outputs come back in the query's
dtype, the MLA contexts in float32 (as JAX's).

Unlike the JAX oracles, which return fresh pools, the paged versions write
the new K/V into the pools IN PLACE and return the same tensors — the port
never copies a page pool per step.  The register-bank versions return new
tensors, as JAX's do.
"""
from __future__ import annotations

import torch


def _broadcast_kv(k: torch.Tensor, n_q_heads: int) -> torch.Tensor:
    """[B, Hkv, T, D] -> [B, Hq, T, D] by repeating groups (GQA)."""
    from repro_torch.sharding.activation import repeat_kv
    return repeat_kv(k, n_q_heads // k.shape[1])


def _gather_pages(pages: torch.Tensor, block_tables: torch.Tensor
                  ) -> torch.Tensor:
    """[P, Hkv, ps, D] pool through [B, maxp] tables -> [B, Hkv, maxp*ps, D].

    ``-1`` entries read page 0 (``safe_bt`` of the JAX oracle): they are
    not skipped, so kernel and oracle agree on what such a slot holds.
    """
    b = block_tables.shape[0]
    _, hkv, _, d = pages.shape
    g = pages[block_tables.clamp(min=0).long()]          # [B, maxp, Hkv, ps, D]
    return g.movedim(2, 1).reshape(b, hkv, -1, d)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: float | None = None,
                    window: int | None = None) -> torch.Tensor:
    """Full-precision reference attention.

    q: [B, Hq, Tq, D]; k, v: [B, Hkv, Tk, D] (Hq % Hkv == 0).  Query i
    sits at key position i + Tk - Tq (ends aligned); ``causal`` keeps keys
    <= that position, ``window`` keys >= it - window + 1.  A query row with
    no live key gives NaN (a softmax over nothing).
    """
    hq, tq, d = q.shape[1], q.shape[2], q.shape[3]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    kb = _broadcast_kv(k, hq)
    vb = _broadcast_kv(v, hq)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kb.float()) * scale
    tk = k.shape[2]
    qi = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
    ki = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki >= qi - window + 1
    logits = logits.masked_fill(~mask[None, None], float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vb.float())
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, scale: float | None = None
                     ) -> torch.Tensor:
    """Single-token decode attention against a (padded) dense KV cache.

    q: [B, Hq, D]; k, v: [B, Hkv, S, D]; kv_len: i32[B] — valid prefix.
    """
    from repro_torch.sharding.activation import by_heads
    hq, d = q.shape[1], q.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    s = k.shape[2]
    mask = (torch.arange(s, device=q.device)[None, :]
            < kv_len.to(q.device)[:, None])

    def attend(q, kb, vb, mask):
        logits = torch.einsum("bhd,bhsd->bhs", q.float(), kb.float()) * scale
        logits = logits.masked_fill(~mask[:, None, :], float("-inf"))
        p = torch.softmax(logits, dim=-1)
        return torch.einsum("bhs,bhsd->bhd", p, vb.float()).to(q.dtype)

    # A per-row mask: [B, 1, S] rides as [B, Tq = 1, S].
    return by_heads(lambda q, kb, vb, m: attend(q, kb, vb, m[:, 0]),
                    q, _broadcast_kv(k, hq), _broadcast_kv(v, hq),
                    mask=mask[:, None])


def _scatter_rows(pages: torch.Tensor, pg: torch.Tensor, slot: torch.Tensor,
                  rows: torch.Tensor, keep: torch.Tensor) -> None:
    """pages[pg, :, slot, :] = rows where ``keep``; dropped writes vanish."""
    pages[pg[keep].long(), :, slot[keep].long(), :] = rows[keep].to(pages.dtype)


def _token_slot(block_tables, pos, ps: int):
    """Page, slot and keep mask of the token write at ``pos``: -1 pages and
    positions past the table drop."""
    maxp = block_tables.shape[1]
    widx = (pos // ps).clamp(max=maxp - 1)
    pg = block_tables.long().gather(1, widx[:, None])[:, 0]
    return pg, pos % ps, (pg >= 0) & (pos < maxp * ps)


def _span_slots(block_tables, start, span, c: int, ps: int):
    """Pages, slots and the keep mask of the span writes: token j < span[b]
    of row b goes to page bt[b, (start+j)//ps] slot (start+j)%ps; -1 pages,
    positions past the table and j >= span drop.  Also the positions."""
    maxp = block_tables.shape[1]
    j = torch.arange(c, device=start.device)
    tpos = start[:, None] + j[None, :]                               # [B, C]
    pg = block_tables.long().gather(1, (tpos // ps).clamp(0, maxp - 1))
    keep = (pg >= 0) & (tpos < maxp * ps) & (j[None, :] < span[:, None])
    return pg, tpos % ps, keep, tpos


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           pos: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, scale: float | None = None,
                           window: int | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode against a paged KV cache, write included.

    q: [B, Hq, D]; k_pages, v_pages: [P, Hkv, ps, D] shared page pool;
    block_tables: i32[B, maxp] page ids per row (-1 = unallocated);
    pos: i32[B] tokens already cached; k_new, v_new: [B, Hkv, D].

    Writes the new token's K/V into page ``block_tables[b, pos // ps]`` slot
    ``pos % ps`` (dropped for -1 pages and positions past the table), then
    attends over the row's ``pos + 1`` live tokens.
    """
    hq, d = q.shape[1], q.shape[2]
    ps = k_pages.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    pos = pos.to(q.device).long()

    pg_w, slot_w, keep = _token_slot(block_tables, pos, ps)
    _scatter_rows(k_pages, pg_w, slot_w, k_new, keep)
    _scatter_rows(v_pages, pg_w, slot_w, v_new, keep)

    kb = _broadcast_kv(_gather_pages(k_pages, block_tables), hq).float()
    vb = _broadcast_kv(_gather_pages(v_pages, block_tables), hq).float()
    logits = torch.einsum("bhd,bhsd->bhs", q.float(), kb) * scale
    cols = torch.arange(kb.shape[2], device=q.device)[None, :]
    valid = cols < (pos + 1)[:, None]
    if window is not None:
        valid &= cols > (pos - window)[:, None]
    logits = logits.masked_fill(~valid[:, None, :], float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhs,bhsd->bhd", p, vb)
    return out.to(q.dtype), k_pages, v_pages


def paged_chunk_attention(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, block_tables: torch.Tensor,
                          start: torch.Tensor, span: torch.Tensor,
                          k_new: torch.Tensor, v_new: torch.Tensor,
                          scale: float | None = None,
                          window: int | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chunked mixed-step attention against a paged KV cache, writes included.

    q: [B, Hq, C, D] per-row query spans; k_pages, v_pages: [P, Hkv, ps, D];
    block_tables: i32[B, maxp]; start: i32[B] tokens already cached per row;
    span: i32[B] valid new tokens in [0, C]; k_new, v_new: [B, Hkv, C, D].

    Writes the span's K/V into pages ``block_tables[b, (start+j) // ps]``
    slot ``(start+j) % ps`` for j < span[b], then each query j attends over
    the row's ``start + j + 1`` live tokens.  Dropped writes: -1 pages,
    positions past the table, and j >= span.  Rows with span 0 write
    nothing; outputs at j >= span are garbage.
    """
    b, hq, c, d = q.shape
    ps = k_pages.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    start = start.to(q.device).long()
    span = span.to(q.device).long()

    pg, slot, keep, tpos = _span_slots(block_tables, start, span, c, ps)
    _scatter_rows(k_pages, pg, slot, k_new.transpose(1, 2), keep)
    _scatter_rows(v_pages, pg, slot, v_new.transpose(1, 2), keep)

    kb = _broadcast_kv(_gather_pages(k_pages, block_tables), hq).float()
    vb = _broadcast_kv(_gather_pages(v_pages, block_tables), hq).float()
    logits = torch.einsum("bhcd,bhsd->bhcs", q.float(), kb) * scale
    cols = torch.arange(kb.shape[2], device=q.device)[None, None, :]
    valid = cols <= tpos[:, :, None]                    # causal to query pos
    if window is not None:
        valid &= cols > (tpos[:, :, None] - window)
    logits = logits.masked_fill(~valid[:, None], float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhcs,bhsd->bhcd", p, vb)
    return out.to(q.dtype), k_pages, v_pages


# ---------------------------------------------------------------------------
# Quantized page pools
# ---------------------------------------------------------------------------
#
# A quantized pool stores one f32 scale per pool row (page, KV head, slot),
# symmetric over the feature axis.  Writing a row quantizes it against its
# own abs-max; the attend reads dequantize_rows of the pools.  The scale is
# never zero (an all-zero row takes 1.0), and int8 rounds half to even.

INT8_QMAX = 127.0
FP8_QMAX = 448.0                    # e4m3 finite max


def quant_qmax(dtype: torch.dtype) -> float:
    """Symmetric representable max the row scale maps abs-max onto."""
    if dtype == torch.int8:
        return INT8_QMAX
    if dtype == torch.float8_e4m3fn:
        return FP8_QMAX
    raise ValueError(f"unsupported quantized pool dtype {dtype}")


def quantize_rows(x: torch.Tensor, dtype: torch.dtype
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize rows of ``x`` ([..., D] float) along the last axis.

    Returns ``(q [..., D] dtype, scale [...] f32)`` with
    ``x ~= q * scale[..., None]``.  The scale multiplies abs-max by the
    float32 reciprocal of qmax explicitly (not abs-max / qmax), as the JAX
    oracle does, so scales are bitwise the same everywhere."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    qmax = quant_qmax(dtype)
    inv = torch.tensor(1.0 / qmax, dtype=torch.float32, device=x.device)
    scale = torch.where(amax > 0, amax * inv, torch.ones_like(amax))
    scaled = xf / scale[..., None]
    if dtype == torch.int8:
        q = torch.round(scaled).clamp(-qmax, qmax).to(torch.int8)
    else:
        q = scaled.to(dtype)
    return q, scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_rows`: ``q [..., D] * scale [...]`` -> f32."""
    return q.float() * scale.float()[..., None]


def paged_decode_attention_quant(q, k_pages, k_scales, v_pages, v_scales,
                                 block_tables, pos, k_new, v_new,
                                 scale: float | None = None,
                                 window: int | None = None):
    """Quantized ``paged_decode_attention``: pools [P, Hkv, ps, D] int8/fp8
    + scales [P, Hkv, ps]; k/v_new arrive float and are quantized into slot
    ``pos`` (pools and scales written in place), then the float32 attend
    runs over the dequantized pools.  Returns (out, k_pages, v_pages,
    k_scales, v_scales)."""
    ps = k_pages.shape[2]
    pos = pos.to(q.device).long()
    kq, ks = quantize_rows(k_new, k_pages.dtype)          # [B,Hkv,D],[B,Hkv]
    vq, vs = quantize_rows(v_new, v_pages.dtype)
    pg_w, slot_w, keep = _token_slot(block_tables, pos, ps)
    for pool, scl, rows, srows in ((k_pages, k_scales, kq, ks),
                                   (v_pages, v_scales, vq, vs)):
        _scatter_rows(pool, pg_w, slot_w, rows, keep)
        scl[pg_w[keep], :, slot_w[keep]] = srows[keep]
    out, _, _ = paged_decode_attention(
        q, dequantize_rows(k_pages, k_scales),
        dequantize_rows(v_pages, v_scales), block_tables, pos,
        dequantize_rows(kq, ks), dequantize_rows(vq, vs), scale=scale,
        window=window)
    return out, k_pages, v_pages, k_scales, v_scales


def paged_chunk_attention_quant(q, k_pages, k_scales, v_pages, v_scales,
                                block_tables, start, span, k_new, v_new,
                                scale: float | None = None,
                                window: int | None = None):
    """Quantized ``paged_chunk_attention``: the span's K/V rows quantize per
    (row, token, head) into the pools and scales (in place), then the
    float32 attend runs over the dequantized pools.  Returns (out, k_pages,
    v_pages, k_scales, v_scales)."""
    c = q.shape[2]
    ps = k_pages.shape[2]
    start = start.to(q.device).long()
    span = span.to(q.device).long()
    kq, ks = quantize_rows(k_new.transpose(1, 2), k_pages.dtype)  # [B,C,Hkv,.]
    vq, vs = quantize_rows(v_new.transpose(1, 2), v_pages.dtype)
    pg, slot, keep, _ = _span_slots(block_tables, start, span, c, ps)
    for pool, scl, rows, srows in ((k_pages, k_scales, kq, ks),
                                   (v_pages, v_scales, vq, vs)):
        _scatter_rows(pool, pg, slot, rows, keep)
        scl[pg[keep], :, slot[keep]] = srows[keep]
    out, _, _ = paged_chunk_attention(
        q, dequantize_rows(k_pages, k_scales),
        dequantize_rows(v_pages, v_scales), block_tables, start, span,
        dequantize_rows(kq, ks).transpose(1, 2),
        dequantize_rows(vq, vs).transpose(1, 2), scale=scale, window=window)
    return out, k_pages, v_pages, k_scales, v_scales


# ---------------------------------------------------------------------------
# Paged MLA (absorbed-weight attention over a latent page pool)
# ---------------------------------------------------------------------------
#
# A latent pool [P, ps, Dp] stores one row concat([ckv; krope]) per token in
# its first r + rd features (Dp is padded to a multiple of 128 at init; the
# pad columns are copied with the row and never scored).  Every head's
# query scores the same row: logits = q_abs·ckv + q_rope·krope, and the
# context is softmax·ckv, r wide, in float32.

def _gather_latent(pages: torch.Tensor, block_tables: torch.Tensor
                   ) -> torch.Tensor:
    """[P, ps, Dp] pool through [B, maxp] tables -> [B, maxp*ps, Dp]; -1
    entries read page 0, as in ``_gather_pages``."""
    b = block_tables.shape[0]
    return pages[block_tables.clamp(min=0).long()].reshape(
        b, -1, pages.shape[-1])


def _mla_attend(q_abs, q_rope, lg, tpos, r: int, scale: float):
    """q_abs: [B, H, C, r]; q_rope: [B, H, C, rd]; lg: gathered latent rows
    [B, S, Dp]; tpos: [B, C] query positions (keys <= tpos attend)."""
    rd = q_rope.shape[-1]
    ckv = lg[..., :r].float()
    krope = lg[..., r:r + rd].float()
    logits = (torch.einsum("bhcr,bsr->bhcs", q_abs.float(), ckv)
              + torch.einsum("bhcr,bsr->bhcs", q_rope.float(), krope)) * scale
    cols = torch.arange(lg.shape[1], device=lg.device)[None, None, :]
    valid = cols <= tpos[:, :, None]
    logits = logits.masked_fill(~valid[:, None], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhcs,bsr->bhcr", probs, ckv)


def paged_mla_chunk(q_abs, q_rope, latent_pages, block_tables, start, span,
                    latent_new, *, r: int, scale: float):
    """Chunked mixed-step MLA against a paged latent cache, writes included.

    q_abs: [B, H, C, r] absorbed queries; q_rope: [B, H, C, rd];
    latent_pages: [P, ps, Dp]; block_tables: i32[B, maxp]; start/span:
    i32[B]; latent_new: [B, C, Dp].  Writes the span's latent rows (in
    place), then query j attends over the row's start + j + 1 rows.
    Returns (ctx [B, H, C, r] float32, latent_pages); ctx at j >= span is
    garbage."""
    ps = latent_pages.shape[1]
    start = start.to(q_abs.device).long()
    span = span.to(q_abs.device).long()
    pg, slot, keep, tpos = _span_slots(block_tables, start, span,
                                       latent_new.shape[1], ps)
    latent_pages[pg[keep], slot[keep]] = latent_new[keep].to(
        latent_pages.dtype)
    ctx = _mla_attend(q_abs, q_rope, _gather_latent(latent_pages,
                                                    block_tables),
                      tpos, r, scale)
    return ctx, latent_pages


def paged_mla_decode(q_abs, q_rope, latent_pages, block_tables, pos,
                     latent_new, *, r: int, scale: float):
    """Single-token MLA decode against a paged latent cache, write included.

    q_abs: [B, H, r]; q_rope: [B, H, rd]; latent_pages: [P, ps, Dp];
    block_tables: i32[B, maxp]; pos: i32[B]; latent_new: [B, Dp].  Writes
    the token's row at slot ``pos`` (dropped for -1 pages and past the
    table), then attends over the row's pos + 1 rows.  Returns (ctx
    [B, H, r] float32, latent_pages)."""
    ps = latent_pages.shape[1]
    pos = pos.to(q_abs.device).long()
    pg, slot, keep = _token_slot(block_tables, pos, ps)
    latent_pages[pg[keep], slot[keep]] = latent_new[keep].to(
        latent_pages.dtype)
    ctx = _mla_attend(q_abs[:, :, None], q_rope[:, :, None],
                      _gather_latent(latent_pages, block_tables),
                      pos[:, None], r, scale)
    return ctx[:, :, 0], latent_pages


def paged_mla_chunk_quant(q_abs, q_rope, latent_pages, latent_scales,
                          block_tables, start, span, latent_new, *,
                          r: int, scale: float):
    """Quantized ``paged_mla_chunk``: latent pool [P, ps, Dp] int8/fp8 +
    f32 scales [P, ps].  The span's Dp-wide rows (pad columns included)
    quantize per row into the pool and scales in place; the attend runs
    over the dequantized pool.  Returns (ctx, latent_pages,
    latent_scales)."""
    ps = latent_pages.shape[1]
    start = start.to(q_abs.device).long()
    span = span.to(q_abs.device).long()
    lq, ls = quantize_rows(latent_new, latent_pages.dtype)    # [B,C,Dp],[B,C]
    pg, slot, keep, _ = _span_slots(block_tables, start, span,
                                    latent_new.shape[1], ps)
    latent_pages[pg[keep], slot[keep]] = lq[keep]
    latent_scales[pg[keep], slot[keep]] = ls[keep]
    ctx, _ = paged_mla_chunk(
        q_abs, q_rope, dequantize_rows(latent_pages, latent_scales),
        block_tables, start, span, dequantize_rows(lq, ls), r=r, scale=scale)
    return ctx, latent_pages, latent_scales


def paged_mla_decode_quant(q_abs, q_rope, latent_pages, latent_scales,
                           block_tables, pos, latent_new, *, r: int,
                           scale: float):
    """Quantized ``paged_mla_decode``: the token's Dp-wide row quantizes
    into slot ``pos``.  Returns (ctx, latent_pages, latent_scales)."""
    ps = latent_pages.shape[1]
    pos = pos.to(q_abs.device).long()
    lq, ls = quantize_rows(latent_new, latent_pages.dtype)      # [B,Dp],[B]
    pg, slot, keep = _token_slot(block_tables, pos, ps)
    latent_pages[pg[keep], slot[keep]] = lq[keep]
    latent_scales[pg[keep], slot[keep]] = ls[keep]
    ctx, _ = paged_mla_decode(
        q_abs, q_rope, dequantize_rows(latent_pages, latent_scales),
        block_tables, pos, dequantize_rows(lq, ls), r=r, scale=scale)
    return ctx, latent_pages, latent_scales


# ---------------------------------------------------------------------------
# Diagonal linear recurrence (RG-LRU): h_t = a_t ⊙ h_{t-1} + b_t
# ---------------------------------------------------------------------------

def linear_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
                ) -> torch.Tensor:
    """h_t = a_t ⊙ h_{t-1} + b_t for every t.  a, b: [B, T, D]; h0: [B, D].
    Returns y [B, T, D] in ``b.dtype``; the carry is float32.

    Each step rounds once, as a fused multiply-add does: a_t·h is exact in
    float64 (two float32 significands), b_t is added there and the sum is
    rounded to float32.  JAX's CPU oracle (``repro.kernels.ref``'s
    ``lax.scan``) rounds the same way, and so does the CUDA kernel's
    ``__fmaf_rn``; two float32 roundings (``a*h`` then ``+ b``) would not.
    """
    from repro_torch.models import scan as scan_mod
    from repro_torch.sharding.activation import whole_dim
    a64 = whole_dim(a, 1).to(torch.float64)
    b64 = whole_dim(b, 1).to(torch.float64)
    h = h0.to(torch.float32)
    n = a.shape[1]
    one = scan_mod.once(n, [a64, b64, h])
    if one is not None:
        # The dry run's counter: one step counted n times (models/scan.py).
        a64, b64, h = one.enter([a64, b64, h])
    ys = []
    for t in range(1 if one is not None else n):
        h = (a64[:, t] * h + b64[:, t]).to(torch.float32)
        ys.append(h)
    if one is not None:
        ys = one.exit(ys) * n
    return torch.stack(ys, dim=1).to(b.dtype)


def rglru(x: torch.Tensor, input_gate: torch.Tensor, rec_gate: torch.Tensor,
          log_lambda: torch.Tensor, h0: torch.Tensor, c: float = 8.0
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Griffin RG-LRU (arXiv:2402.19427 eq. 3-4).

    x, input_gate, rec_gate: [B, T, D] (gates pre-activation); log_lambda:
    [D] (softplus domain); h0: [B, D].  Returns (y [B, T, D] in x's dtype,
    h_T [B, D] float32).
    """
    i_t = torch.sigmoid(input_gate.float())
    r_t = torch.sigmoid(rec_gate.float())
    log_a = -c * r_t * torch.nn.functional.softplus(
        log_lambda.float())[None, None, :]
    a_t = torch.exp(log_a)
    gated_x = i_t * x.float()
    b_t = torch.sqrt(torch.clamp(1.0 - a_t ** 2, min=1e-9)) * gated_x
    hs = linear_scan(a_t, b_t, h0)
    return hs.to(x.dtype), hs[:, -1].float()


# ---------------------------------------------------------------------------
# Cross-pool page transfer (disaggregated adoption)
# ---------------------------------------------------------------------------

def page_transfer(src_pool: torch.Tensor, dst_pool: torch.Tensor,
                  src_ids: torch.Tensor, dst_ids: torch.Tensor
                  ) -> torch.Tensor:
    """Lane i copies ``src_pool[src_ids[i]]`` into ``dst_pool[dst_ids[i]]``,
    in place; returns ``dst_pool``.  A -1 on either side drops the lane, and
    so does a ``dst_id >= dst_pool.shape[0]``; a ``src_id`` past the pool
    reads its last row (JAX's clip).  Where live lanes share a destination
    the last one wins, as in the Pallas kernel's sequential grid (and in
    JAX's CPU scatter): lanes a later live lane supersedes are dropped
    before the one scatter, so the result does not depend on the order a
    parallel scatter would apply duplicates in.  A copy of bits, so exact
    for every dtype.
    """
    s = src_ids.to(device=dst_pool.device, dtype=torch.long)
    d = dst_ids.to(device=dst_pool.device, dtype=torch.long)
    live = (s >= 0) & (d >= 0) & (d < dst_pool.shape[0])
    n = s.shape[0]
    later = torch.ones((n, n), dtype=torch.bool,
                       device=d.device).triu(diagonal=1)
    superseded = ((d[:, None] == d[None, :]) & live[None, :] & later).any(1)
    win = live & ~superseded
    rows = src_pool[s[win].clamp(0, src_pool.shape[0] - 1)]
    dst_pool[d[win]] = rows
    return dst_pool


# ---------------------------------------------------------------------------
# Register banks: LWW join and delta scatter-apply (replica sync)
# ---------------------------------------------------------------------------

INT32_MIN = torch.iinfo(torch.int32).min


def _rows(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-register mask [K] shaped to broadcast over ``x`` [K, ...]."""
    return mask.reshape(mask.shape + (1,) * (x.dim() - 1))


def lww_merge(key_a: torch.Tensor, pay_a: torch.Tensor, key_b: torch.Tensor,
              pay_b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-register join of two banks: the larger packed (clock, client)
    key wins and its payload row comes with it; on equal keys ``a`` wins.

    key_*: int32 [K]; pay_*: [K, D] (any dtype).  Returns new tensors.
    """
    b_wins = key_b > key_a
    return (torch.where(b_wins, key_b, key_a),
            torch.where(_rows(b_wins, pay_a), pay_b, pay_a))


def delta_apply(key: torch.Tensor, pay: torch.Tensor, d_idx: torch.Tensor,
                d_key: torch.Tensor, d_pay: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply an LWW delta buffer: lane ``j`` writes register ``d_idx[j]``
    (key ``d_key[j]``, payload row ``d_pay[j]`` cast to ``pay``'s dtype)
    where its key is strictly greater than the bank's.

    key: int32 [K]; pay: [K, D]; d_idx, d_key: int32 [Dc]; d_pay: [Dc, D].
    A ``d_idx`` outside [0, K) is an empty lane (-1 by convention; JAX's
    ``mode="drop"`` drops every such index).  Returns new tensors.

    Duplicate targets: for each register the lane with the LARGEST key
    wins, if that key beats the bank's; among lanes with that same key the
    LOWEST lane index wins.  That is the result of the Pallas kernel's
    in-order lane sweep with a strict ``>`` (JAX's jnp oracle leaves it to
    XLA's scatter order).  Here it is two deterministic reductions: the
    max key per target, then the min lane index among the lanes at it.
    """
    k, dc = key.shape[0], d_idx.shape[0]
    tgt = d_idx.long()
    live = (tgt >= 0) & (tgt < k)
    tgt = torch.where(live, tgt, k)                 # empty lanes: spare row k
    bank = torch.cat([key, key.new_full((1,), INT32_MIN)])
    top = bank.scatter_reduce(0, tgt, d_key.to(key.dtype), "amax")
    at_top = live & (d_key == top[tgt]) & (d_key > bank[tgt])
    lane = torch.arange(dc, device=key.device)
    first = torch.full((k + 1,), dc, dtype=torch.long,
                       device=key.device).scatter_reduce(
        0, torch.where(at_top, tgt, k), torch.where(at_top, lane, dc),
        "amin")[:k]
    won = first < dc
    out_pay = pay.clone()
    out_pay[won] = d_pay.to(pay.dtype)[first[won]]
    return torch.where(won, top[:k], key), out_pay


# ---------------------------------------------------------------------------
# Speculative-decoding verify path (span acceptance + rollback)
# ---------------------------------------------------------------------------

def speculative_accept(preds: torch.Tensor, tokens: torch.Tensor,
                       span: torch.Tensor) -> torch.Tensor:
    """Greedy longest-accepted-prefix count per row.

    preds: i32[B, C] argmax at every span position (the verify step's
    all-logits mixed step); tokens: i32[B, C] the span fed,
    ``tokens[b] = [last_committed, d_1 .. d_m, pad]``; span: i32[B] = 1 + m.
    Draft d_{j+1} is accepted iff every earlier one was and
    ``preds[b, j] == tokens[b, j + 1]``.  Counts lie in [0, m]; rows with
    span <= 1 count 0.  ``preds[b, accepted[b]]`` is the bonus token, the
    one plain greedy decoding would emit next.
    """
    b, c = tokens.shape
    if c == 1:
        return torch.zeros((b,), dtype=torch.int32, device=tokens.device)
    span = span.to(tokens.device)
    j = torch.arange(c - 1, device=tokens.device)
    ok = (preds[:, :-1] == tokens[:, 1:]) & (j[None, :] < span[:, None] - 1)
    # argmin returns the first minimum: the first rejected position.
    first_bad = torch.argmin(ok.to(torch.int32), dim=1)
    return torch.where(ok.all(dim=1), c - 1, first_bad).to(torch.int32)


def _span_pages(block_tables: torch.Tensor, start: torch.Tensor, width: int,
                ps: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(positions [B, W], table entries [B, W] (-1 kept), slots [B, W]) of
    the window [start, start + width); positions past the table read its
    last entry."""
    bt = block_tables.long()
    maxp = bt.shape[-1]
    tpos = (start.to(bt.device).long()[:, None]
            + torch.arange(width, device=bt.device)[None, :])
    pg = torch.take_along_dim(bt, (tpos // ps).clamp(0, maxp - 1), dim=1)
    return tpos, pg, tpos % ps


def paged_span_slots(block_tables: torch.Tensor, start: torch.Tensor,
                     width: int, ps: int, num_pages: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(pages, slots), each [B, W]: where ``paged_span_gather`` reads the
    window [start, start + width) in a pool of ``num_pages`` pages of
    ``ps`` slots (pages clamped into the pool).  Every leaf that shares the
    tables takes the same pair."""
    _, pg, slot = _span_pages(block_tables, start, width, ps)
    return pg.clamp(0, num_pages - 1), slot


def paged_span_lanes(block_tables: torch.Tensor, start: torch.Tensor,
                     lo: torch.Tensor, hi: torch.Tensor, width: int, ps: int,
                     num_pages: int) -> tuple[torch.Tensor, ...]:
    """(rows, offsets, pages, slots), each 1-D with one entry a lane that
    ``paged_span_restore`` writes: window positions in [lo[b], hi[b])
    inside the table with an allocated entry (a page past the pool writes
    its last page, as JAX's clip).  One device-to-host sync (the count of
    lanes); every leaf that shares the tables takes the same lanes."""
    tpos, pg, slot = _span_pages(block_tables, start, width, ps)
    dev = tpos.device
    keep = ((tpos >= lo.to(dev).long()[:, None])
            & (tpos < hi.to(dev).long()[:, None])
            & (tpos // ps < block_tables.shape[-1]) & (pg >= 0))
    b, w = keep.nonzero(as_tuple=True)
    return b, w, pg[b, w].clamp(max=num_pages - 1), slot[b, w]


def paged_span_gather(pool: torch.Tensor, block_tables: torch.Tensor,
                      start: torch.Tensor, width: int,
                      slot_axis: int | None = None,
                      slots: tuple[torch.Tensor, torch.Tensor] | None = None
                      ) -> torch.Tensor:
    """A copy of the pool slots a mixed-step write window covers.

    ``out[b, w] = pool[block_tables[b, (start[b]+w) // ps], ...,
    (start[b]+w) % ps, ...]``: the pre-verify bytes of every slot a span
    written at [start, start + width) could touch.  pool: [P, Hkv, ps, D]
    (MHA K/V, slot axis 2) or [P, ps, Dp] (MLA latent, slot axis 1).
    Scale leaves drop the trailing feature axis but keep the slot axis,
    [P, Hkv, ps] (slot axis 2) or [P, ps] (slot axis 1): pass ``slot_axis``
    for those.  Positions past the table and -1 entries are clamped; their
    lanes hold garbage that ``paged_span_restore`` masks out.  ``slots``
    takes ``paged_span_slots``' pair where the caller has it.  Advanced
    indexing copies, so the snapshot survives the verify step's in-place
    writes.
    """
    if slot_axis is None:
        slot_axis = 2 if pool.dim() == 4 else 1
    pg, slot = slots or paged_span_slots(block_tables, start, width,
                                         pool.shape[slot_axis], pool.shape[0])
    if slot_axis == 2:
        return pool[pg, :, slot]             # [B, W, Hkv, (D)]
    return pool[pg, slot]                    # [B, W, (Dp)]


def paged_span_restore(pool: torch.Tensor, snap: torch.Tensor,
                       block_tables: torch.Tensor, start: torch.Tensor,
                       lo: torch.Tensor, hi: torch.Tensor,
                       slot_axis: int | None = None,
                       lanes: tuple[torch.Tensor, ...] | None = None
                       ) -> torch.Tensor:
    """Rejected-tail rollback, in place: write ``snap`` (from
    ``paged_span_gather`` at the same ``start``) back at positions in
    [lo[b], hi[b]); returns ``pool``.

    Lanes outside the window (accepted positions, rows with lo == hi,
    positions past the table, -1 entries) are dropped, so committed slots
    keep the verify step's writes bit for bit and the rejected tail gets
    its pre-verify bytes back.  ``slot_axis`` as in ``paged_span_gather``;
    ``lanes`` takes ``paged_span_lanes``' result where the caller has it.
    """
    if slot_axis is None:
        slot_axis = 2 if pool.dim() == 4 else 1
    b, w, pg, slot = lanes or paged_span_lanes(
        block_tables, start, lo, hi, snap.shape[1], pool.shape[slot_axis],
        pool.shape[0])
    vals = snap[b, w].to(pool.dtype)
    if slot_axis == 2:
        pool[pg, :, slot] = vals
    else:
        pool[pg, slot] = vals
    return pool
