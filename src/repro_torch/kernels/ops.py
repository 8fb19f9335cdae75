"""Public wrappers around the port's kernels: attention, the RG-LRU's
linear recurrence, the cross-pool page transfer and the two register-bank
operations of replica sync.

Each wrapper applies the contract of its ``repro.kernels.ops`` counterpart
on every path, then dispatches by device:

  * a CPU tensor takes the plain PyTorch version in ``ref``;
  * a CUDA tensor launches the Hopper kernel, or raises — there is no
    fallback.  No kernel has a backward (nor has any Pallas kernel of the
    JAX package), so on the card a wrapper also raises while grad mode is
    on and an input requires grad: its output would end the gradient
    without a word.  Training runs ``impl="ref"``.

``impl="ref"`` asks for the plain version on any device: the model's plain
path, which ``chip_smoke.py`` holds the kernel path against on the card
(the JAX wrappers' ``use_pallas=False``).

The paged pools are updated in place and never padded per step; the TPU
tileability guard and 128-lane padding of the JAX wrappers have no
counterpart here.

    out = ops.flash_attention(q, k, v, causal=False)       # whole sequences
    out = ops.decode_attention(q, k, v, kv_len)                       # dense
    out, kp, vp = ops.paged_decode_attention(q, kp, vp, bt, pos, kn, vn)
    out, kp, vp = ops.paged_chunk_attention(q, kp, vp, bt, start, span,
                                            kn, vn)
    out, kp, vp, ks, vs = ops.paged_decode_attention_quant(
        q, kp, ks, vp, vs, bt, pos, kn, vn)              # int8 / fp8 pools
    out, kp, vp, ks, vs = ops.paged_chunk_attention_quant(
        q, kp, ks, vp, vs, bt, start, span, kn, vn)
    ctx, lp = ops.paged_mla_decode(q_abs, q_rope, lp, bt, pos, ln,
                                   scale=s)              # MLA latent pool
    ctx, lp = ops.paged_mla_chunk(q_abs, q_rope, lp, bt, start, span, ln,
                                  scale=s)
    ctx, lp, ls = ops.paged_mla_decode_quant(q_abs, q_rope, lp, ls, bt, pos,
                                             ln, scale=s)
    ctx, lp, ls = ops.paged_mla_chunk_quant(q_abs, q_rope, lp, ls, bt,
                                            start, span, ln, scale=s)
    y, h_last = ops.linear_scan(a, b, h0)          # h_t = a_t h_{t-1} + b_t
    dst_pool = ops.page_transfer(src_pool, dst_pool, src_ids, dst_ids)
    dsts = ops.page_transfer_leaves([(src_pool, dst_pool), ...], src_ids,
                                    dst_ids)             # one launch
    key, pay = ops.lww_merge(key_a, pay_a, key_b, pay_b)      # LWW join
    key, pay = ops.delta_apply(key, pay, d_idx, d_key, d_pay)
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import delta_apply as _delta
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import linear_scan as _scan
from repro_torch.kernels import lww_merge as _lww
from repro_torch.kernels import paged_chunk_attention as _pchunk
from repro_torch.kernels import paged_chunk_attention_quant as _pchunk_q
from repro_torch.kernels import paged_decode_attention as _pdec
from repro_torch.kernels import paged_decode_attention_quant as _pdec_q
from repro_torch.kernels import paged_mla_chunk as _mchunk
from repro_torch.kernels import paged_mla_chunk_quant as _mchunk_q
from repro_torch.kernels import paged_mla_decode as _mdec
from repro_torch.kernels import paged_mla_decode_quant as _mdec_q
from repro_torch.kernels import page_transfer as _xfer
from repro_torch.kernels import ref

KERNELS = {"decode_attention": _dec, "paged_decode_attention": _pdec,
           "paged_chunk_attention": _pchunk,
           "paged_decode_attention_quant": _pdec_q,
           "paged_chunk_attention_quant": _pchunk_q,
           "paged_mla_decode": _mdec, "paged_mla_chunk": _mchunk,
           "paged_mla_decode_quant": _mdec_q,
           "paged_mla_chunk_quant": _mchunk_q, "linear_scan": _scan,
           "page_transfer": _xfer, "flash_attention": _flash,
           "lww_merge": _lww, "delta_apply": _delta}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0


class ShardedKernelError(RuntimeError):
    """A ``DTensor`` reached a kernel wrapper with ``impl="kernel"``."""


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _plain(impl: str, kernel: str, x: torch.Tensor, *rest) -> bool:
    """True where the plain version runs: asked for, or ``x`` is a CPU
    tensor.  On the card the kernel runs, unless grad mode is on and an
    input (``x`` or ``rest``) requires grad: then this raises, because no
    kernel has a backward and its output would end the gradient without a
    word.  A ``DTensor`` (a sharded run) takes the plain version under
    ``impl="ref"`` and raises ``ShardedKernelError`` under
    ``impl="kernel"``: a kernel takes one card's whole tensors, and a
    ``DTensor``'s pointer is one rank's shard."""
    if impl not in ("kernel", "ref"):
        raise ValueError(f"impl must be 'kernel' or 'ref', got {impl!r}")
    if any(_is_dtensor(t) for t in (x, *rest)):
        if impl == "kernel":
            raise ShardedKernelError(
                f"{kernel}: a DTensor reached the kernel wrapper with "
                f"impl='kernel'; the kernels run on one card's plain "
                f"tensors, so a sharded run passes impl='ref'")
        return True
    if impl == "ref":
        return True
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *rest) if t is not None):
        raise RuntimeError(
            f"{kernel}: an input requires grad, but the CUDA kernel has no "
            f"backward (nor has its Pallas counterpart in the JAX "
            f"package), so the gradient would stop here silently; training "
            f"runs impl='ref' (lm.loss_fn's default), and inference calls "
            f"the kernel under torch.no_grad()")
    return False


# ---------------------------------------------------------------------------
# The paged plain versions on DTensors (a sharded run, impl="ref")
# ---------------------------------------------------------------------------
#
# A paged pool is shared by every row, so no batch axis shards it: it is
# replicated over the data axes (and split over model by heads, or by the
# latent features).  Every rank writes every row's new K/V into its copy,
# so the copies stay equal, as GSPMD makes a scatter of batch-sharded rows
# into a replicated operand gather the rows first; the attend then runs on
# every row too (each data rank computes all rows' outputs, which the next
# op slices to its own: the plain path's cost, not the kernels').

def _whole(fn, q, pools, block_tables, idx, news, **kw):
    return fn(q, *pools, block_tables, *idx, *news, **kw)


def _full(x):
    return x.full_tensor() if _is_dtensor(x) else x


def _as(x, mesh, placements):
    """This rank's local tensor of ``x`` under ``placements``."""
    from torch.distributed.tensor import distribute_tensor
    if _is_dtensor(x):
        return x.redistribute(mesh, placements).to_local()
    return distribute_tensor(x, mesh, placements,
                             src_data_rank=None).to_local()


def like_pool(x, pool, dim: int) -> torch.Tensor:
    """This rank's local ``x`` (every row) with its ``dim`` split over
    the mesh dims that split ``pool`` (heads, or latent features), for a
    write into ``pool.to_local()``."""
    from torch.distributed.tensor import Replicate, Shard
    d = dim % x.dim()
    return _as(x, pool.device_mesh, tuple(
        Shard(d) if isinstance(p, Shard) else Replicate()
        for p in pool.placements))


def _no_sharded_pool(kernel: str, *pools) -> None:
    if any(_is_dtensor(p) for p in pools):
        raise NotImplementedError(
            f"{kernel}: quantized page pools do not run sharded yet (the "
            f"partitioner splits their scale leaves over pages)")


def _on_head_shards(fn, q, pools, block_tables, idx, news, **kw):
    """``fn`` (a paged MHA plain version) on each rank's pool shard (its
    heads, or all of them where the heads do not divide model): every
    row, the matching query and new-K/V heads; the output has the pool's
    head placement and every row."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = pools[0].device_mesh
    heads = tuple(Shard(1) if isinstance(p, Shard) else Replicate()
                  for p in pools[0].placements)
    out = fn(_as(q, mesh, heads), *(p.to_local() for p in pools),
             _full(block_tables), *(_full(i) for i in idx),
             *(_as(n, mesh, heads) for n in news), **kw)
    o = DTensor.from_local(out[0], mesh, heads, run_check=False,
                           shape=q.shape, stride=q.stride())
    return (o, *pools)


def _on_latent_shards(fn, q_abs, q_rope, pool, block_tables, idx,
                      latent_new, **kw):
    """``fn`` (a paged MLA plain version) on a latent pool split over
    model by features: every row's new latent row goes into each rank's
    feature slice, then the attend, which contracts over the whole latent
    width, runs on the pool gathered over model (an all-gather of the
    pool a call: the plain sharded path's cost)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = pool.device_mesh
    rep = (Replicate(),) * mesh.ndim
    feats = tuple(Shard(1) if isinstance(p, Shard) else Replicate()
                  for p in pool.placements)
    table, index = _full(block_tables), tuple(_full(i) for i in idx)
    local = pool.to_local()
    rows = _as(latent_new, mesh, feats)
    ps = local.shape[1]
    if len(index) == 1:
        pg, slot, keep = ref._token_slot(table, index[0].long(), ps)
        local[pg[keep], slot[keep]] = rows[keep].to(local.dtype)
    else:
        start, span = index
        pg, slot, keep, _ = ref._span_slots(table, start.long(),
                                            span.long(), rows.shape[1], ps)
        local[pg[keep], slot[keep]] = rows[keep].to(local.dtype)
    whole = pool.redistribute(mesh, rep).to_local()
    ctx, _ = fn(_as(q_abs, mesh, rep), _as(q_rope, mesh, rep), whole,
                table, *index, _as(latent_new, mesh, rep), **kw)
    return (DTensor.from_local(ctx, mesh, rep, run_check=False), pool)


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, window: int | None = None,
                    impl: str = "kernel"):
    """q: [B, Hq, Tq, D]; k, v: [B, Hkv, Tk, D] -> [B, Hq, Tq, D].

    Query i sits at key position i + Tk - Tq.  A query row with no live
    key gives NaN in the plain version and 0 from the kernel."""
    if _plain(impl, "flash_attention", q, k, v):
        return ref.flash_attention(q, k, v, causal=causal, scale=scale,
                                   window=window)
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    return _flash.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal,
                                  scale=scale, window=window)


def decode_attention(q, k, v, kv_len, *, scale: float | None = None,
                     impl: str = "kernel"):
    """q: [B, Hq, D]; k, v: [B, Hkv, S, D]; kv_len: i32[B] -> [B, Hq, D]."""
    if _plain(impl, "decode_attention", q, k, v):
        return ref.decode_attention(q, k, v, kv_len, scale=scale)
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    return _dec.decode_attention(q.contiguous(), k, v,
                                 kv_len.to(torch.int32).contiguous(),
                                 scale=scale)


def paged_decode_attention(q, k_pages, v_pages, block_tables, pos, k_new,
                           v_new, *, scale: float | None = None,
                           window: int | None = None, impl: str = "kernel"):
    """Fused write-attend decode over a paged KV cache.

    q: [B, Hq, D]; k_pages, v_pages: [P, Hkv, ps, D]; block_tables:
    i32[B, maxp]; pos: i32[B]; k_new, v_new: [B, Hkv, D].  Returns
    (out [B, Hq, D], k_pages, v_pages), the pools carrying the new token at
    slot ``pos``.  ``pos`` is clamped to the table's capacity on both paths:
    past it the last slot is rewritten instead of the table read out of
    bounds.
    """
    ps = k_pages.shape[2]
    pos = pos.clamp(max=block_tables.shape[1] * ps - 1)
    k_new = k_new.to(k_pages.dtype)
    v_new = v_new.to(v_pages.dtype)
    if _plain(impl, "paged_decode_attention", q, k_pages, v_pages, k_new,
              v_new):
        fn = _on_head_shards if _is_dtensor(k_pages) else _whole
        return fn(ref.paged_decode_attention, q, (k_pages, v_pages),
                  block_tables, (pos,), (k_new, v_new), scale=scale,
                  window=window)
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    return _pdec.paged_decode_attention(
        q.contiguous(), k_pages, v_pages,
        block_tables.to(torch.int32).contiguous(),
        pos.to(torch.int32).contiguous(), k_new.contiguous(),
        v_new.contiguous(), scale=scale, window=window)


def paged_chunk_attention(q, k_pages, v_pages, block_tables, start, span,
                          k_new, v_new, *, scale: float | None = None,
                          window: int | None = None, impl: str = "kernel"):
    """Chunked mixed-step attention over a paged KV cache, writes fused.

    q: [B, Hq, C, D]; k_pages, v_pages: [P, Hkv, ps, D]; block_tables:
    i32[B, maxp]; start: i32[B] tokens already cached; span: i32[B] new
    tokens; k_new, v_new: [B, Hkv, C, D].  Returns (out [B, Hq, C, D],
    k_pages, v_pages) with the span written at slots ``start..start+span``.
    ``start`` is clamped to the table's capacity and ``span`` clipped to
    [0, C] on both paths.
    """
    ps = k_pages.shape[2]
    start = start.clamp(max=block_tables.shape[1] * ps - 1)
    span = span.clamp(0, q.shape[2])
    k_new = k_new.to(k_pages.dtype)
    v_new = v_new.to(v_pages.dtype)
    if _plain(impl, "paged_chunk_attention", q, k_pages, v_pages, k_new,
              v_new):
        fn = _on_head_shards if _is_dtensor(k_pages) else _whole
        return fn(ref.paged_chunk_attention, q, (k_pages, v_pages),
                  block_tables, (start, span), (k_new, v_new), scale=scale,
                  window=window)
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    return _pchunk.paged_chunk_attention(
        q.contiguous(), k_pages, v_pages,
        block_tables.to(torch.int32).contiguous(),
        start.to(torch.int32).contiguous(), span.to(torch.int32).contiguous(),
        k_new.contiguous(), v_new.contiguous(), scale=scale, window=window)


def paged_decode_attention_quant(q, k_pages, k_scales, v_pages, v_scales,
                                 block_tables, pos, k_new, v_new, *,
                                 scale: float | None = None,
                                 window: int | None = None,
                                 impl: str = "kernel"):
    """Quantized-pool fused write-attend decode.

    The contract of ``paged_decode_attention`` with int8 / float8_e4m3fn
    pools and f32 row scales (k/v_scales: [P, Hkv, ps]) beside them; k/v_new
    arrive float32 or bf16 and are quantized in the fused write.  Returns
    (out, k_pages, v_pages, k_scales, v_scales), pools and scales in place.
    ``pos`` is clamped to the table's capacity on both paths.
    """
    ps = k_pages.shape[2]
    pos = pos.clamp(max=block_tables.shape[1] * ps - 1)
    _no_sharded_pool("paged_decode_attention_quant", k_pages, k_scales)
    if _plain(impl, "paged_decode_attention_quant", q, k_scales, v_scales,
              k_new, v_new):
        return ref.paged_decode_attention_quant(
            q, k_pages, k_scales, v_pages, v_scales, block_tables, pos,
            k_new, v_new, scale=scale, window=window)
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    return _pdec_q.paged_decode_attention_quant(
        q.contiguous(), k_pages, k_scales, v_pages, v_scales,
        block_tables.to(torch.int32).contiguous(),
        pos.to(torch.int32).contiguous(), k_new.contiguous(),
        v_new.contiguous(), scale=scale, window=window)


def paged_chunk_attention_quant(q, k_pages, k_scales, v_pages, v_scales,
                                block_tables, start, span, k_new, v_new, *,
                                scale: float | None = None,
                                window: int | None = None,
                                impl: str = "kernel"):
    """Quantized-pool chunked mixed-step attention.

    The contract of ``paged_chunk_attention`` with int8 / float8_e4m3fn
    pools and f32 row scales; k/v_new arrive float32 or bf16 [B, Hkv, C, D]
    and are quantized in the fused multi-slot write.  Returns (out, k_pages,
    v_pages, k_scales, v_scales).  ``start`` is clamped to the table's
    capacity and ``span`` clipped to [0, C] on both paths.
    """
    ps = k_pages.shape[2]
    start = start.clamp(max=block_tables.shape[1] * ps - 1)
    span = span.clamp(0, q.shape[2])
    _no_sharded_pool("paged_chunk_attention_quant", k_pages, k_scales)
    if _plain(impl, "paged_chunk_attention_quant", q, k_scales, v_scales,
              k_new, v_new):
        return ref.paged_chunk_attention_quant(
            q, k_pages, k_scales, v_pages, v_scales, block_tables, start,
            span, k_new, v_new, scale=scale, window=window)
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    return _pchunk_q.paged_chunk_attention_quant(
        q.contiguous(), k_pages, k_scales, v_pages, v_scales,
        block_tables.to(torch.int32).contiguous(),
        start.to(torch.int32).contiguous(), span.to(torch.int32).contiguous(),
        k_new.contiguous(), v_new.contiguous(), scale=scale, window=window)


# ---------------------------------------------------------------------------
# Paged MLA: absorbed-weight attention over a latent page pool [P, ps, Dp]
# ---------------------------------------------------------------------------

def _mla_widths(q_abs, q_rope, latent_pages) -> tuple[int, int]:
    r, rd = q_abs.shape[-1], q_rope.shape[-1]
    dp = latent_pages.shape[-1]
    if dp < r + rd:
        raise ValueError(f"latent pool width {dp} < kv_lora_rank + rope_dim "
                         f"= {r + rd}")
    return r, rd


def _mla_q_parts(q_abs, q_rope, latent_pages) -> tuple[torch.Tensor, ...]:
    """The kernels' query, read in place in its two parts: q_abs float32,
    q_rope in its own dtype where a tensor-core walk takes it (float32 or
    bf16; the float32 pool's FMA walk takes float32), each contiguous and
    16-byte aligned.  No concat: one contraction over the latent row's
    r + rd live features happens in the kernel."""
    def aligned(t):
        t = t.contiguous()
        return t if t.data_ptr() % 16 == 0 else t.clone()
    keep = (q_rope.dtype in (torch.float32, torch.bfloat16)
            and latent_pages.dtype != torch.float32)
    return aligned(q_abs.float()), aligned(q_rope if keep else q_rope.float())


def paged_mla_decode(q_abs, q_rope, latent_pages, block_tables, pos,
                     latent_new, *, scale: float, impl: str = "kernel"):
    """Fused write-attend MLA decode over a paged latent cache.

    q_abs: [B, H, r] absorbed queries; q_rope: [B, H, rd]; latent_pages:
    [P, ps, Dp] with Dp >= r + rd; block_tables: i32[B, maxp]; pos: i32[B];
    latent_new: [B, Dp].  Returns (ctx [B, H, r] float32, latent_pages)
    with the token's row written at slot ``pos`` in place.  ``pos`` is
    clamped to the table's capacity on both paths.
    """
    r, _ = _mla_widths(q_abs, q_rope, latent_pages)
    ps = latent_pages.shape[1]
    pos = pos.clamp(max=block_tables.shape[1] * ps - 1)
    latent_new = latent_new.to(latent_pages.dtype)
    if _plain(impl, "paged_mla_decode", q_abs, q_rope, latent_pages,
              latent_new):
        if _is_dtensor(latent_pages):
            return _on_latent_shards(ref.paged_mla_decode, q_abs, q_rope,
                                     latent_pages, block_tables, (pos,),
                                     latent_new, r=r, scale=scale)
        return ref.paged_mla_decode(q_abs, q_rope, latent_pages,
                                    block_tables, pos, latent_new, r=r,
                                    scale=scale)
    return _mdec.paged_mla_decode(
        *_mla_q_parts(q_abs, q_rope, latent_pages), latent_pages,
        block_tables.to(torch.int32).contiguous(),
        pos.to(torch.int32).contiguous(), latent_new.contiguous(),
        scale=scale)


def paged_mla_chunk(q_abs, q_rope, latent_pages, block_tables, start, span,
                    latent_new, *, scale: float, impl: str = "kernel"):
    """Chunked mixed-step MLA over a paged latent cache, span write fused.

    q_abs: [B, H, C, r]; q_rope: [B, H, C, rd]; latent_pages: [P, ps, Dp]
    with Dp >= r + rd; block_tables: i32[B, maxp]; start/span: i32[B];
    latent_new: [B, C, Dp].  Returns (ctx [B, H, C, r] float32,
    latent_pages) with the span written in place.  ``start`` is clamped to
    the table's capacity and ``span`` clipped to [0, C] on both paths.
    """
    r, _ = _mla_widths(q_abs, q_rope, latent_pages)
    ps = latent_pages.shape[1]
    start = start.clamp(max=block_tables.shape[1] * ps - 1)
    span = span.clamp(0, q_abs.shape[2])
    latent_new = latent_new.to(latent_pages.dtype)
    if _plain(impl, "paged_mla_chunk", q_abs, q_rope, latent_pages,
              latent_new):
        if _is_dtensor(latent_pages):
            return _on_latent_shards(ref.paged_mla_chunk, q_abs, q_rope,
                                     latent_pages, block_tables,
                                     (start, span), latent_new, r=r,
                                     scale=scale)
        return ref.paged_mla_chunk(q_abs, q_rope, latent_pages,
                                   block_tables, start, span, latent_new,
                                   r=r, scale=scale)
    return _mchunk.paged_mla_chunk(
        *_mla_q_parts(q_abs, q_rope, latent_pages), latent_pages,
        block_tables.to(torch.int32).contiguous(),
        start.to(torch.int32).contiguous(), span.to(torch.int32).contiguous(),
        latent_new.contiguous(), scale=scale)


def paged_mla_decode_quant(q_abs, q_rope, latent_pages, latent_scales,
                           block_tables, pos, latent_new, *, scale: float,
                           impl: str = "kernel"):
    """Quantized-pool fused write-attend MLA decode.

    The contract of ``paged_mla_decode`` with an int8 / float8_e4m3fn
    latent pool and f32 row scales (latent_scales: [P, ps]); latent_new
    arrives float32 or bf16 [B, Dp] and is quantized, pad columns
    included, in the fused write.  Returns (ctx, latent_pages,
    latent_scales), pool and scales in place.
    """
    r, _ = _mla_widths(q_abs, q_rope, latent_pages)
    ps = latent_pages.shape[1]
    pos = pos.clamp(max=block_tables.shape[1] * ps - 1)
    _no_sharded_pool("paged_mla_decode_quant", latent_pages, latent_scales)
    if _plain(impl, "paged_mla_decode_quant", q_abs, q_rope, latent_scales,
              latent_new):
        return ref.paged_mla_decode_quant(
            q_abs, q_rope, latent_pages, latent_scales, block_tables, pos,
            latent_new, r=r, scale=scale)
    return _mdec_q.paged_mla_decode_quant(
        *_mla_q_parts(q_abs, q_rope, latent_pages), latent_pages,
        latent_scales,
        block_tables.to(torch.int32).contiguous(),
        pos.to(torch.int32).contiguous(), latent_new.contiguous(),
        scale=scale)


def paged_mla_chunk_quant(q_abs, q_rope, latent_pages, latent_scales,
                          block_tables, start, span, latent_new, *,
                          scale: float, impl: str = "kernel"):
    """Quantized-pool chunked mixed-step MLA.

    The contract of ``paged_mla_chunk`` with an int8 / float8_e4m3fn
    latent pool and f32 row scales [P, ps]; latent_new arrives float32 or
    bf16 [B, C, Dp] and is quantized in the fused multi-slot write.
    Returns (ctx, latent_pages, latent_scales).
    """
    r, _ = _mla_widths(q_abs, q_rope, latent_pages)
    ps = latent_pages.shape[1]
    start = start.clamp(max=block_tables.shape[1] * ps - 1)
    span = span.clamp(0, q_abs.shape[2])
    _no_sharded_pool("paged_mla_chunk_quant", latent_pages, latent_scales)
    if _plain(impl, "paged_mla_chunk_quant", q_abs, q_rope, latent_scales,
              latent_new):
        return ref.paged_mla_chunk_quant(
            q_abs, q_rope, latent_pages, latent_scales, block_tables, start,
            span, latent_new, r=r, scale=scale)
    return _mchunk_q.paged_mla_chunk_quant(
        *_mla_q_parts(q_abs, q_rope, latent_pages), latent_pages,
        latent_scales,
        block_tables.to(torch.int32).contiguous(),
        start.to(torch.int32).contiguous(), span.to(torch.int32).contiguous(),
        latent_new.contiguous(), scale=scale)


def linear_scan(a, b, h0, *, impl: str = "kernel"):
    """h_t = a_t ⊙ h_{t-1} + b_t.  a, b: [B, T, D]; h0: [B, D].  Returns
    (y [B, T, D] in b's dtype, h_T [B, D] float32).

    The plain path returns y's last step as h_T, as JAX's
    ``use_pallas=False`` does (the float32 carry itself when b is float32,
    as on the model's path); the kernel returns the float32 carry, as JAX's
    Pallas kernel does.  Time is not padded with identity steps: the
    kernel walks t < T.
    """
    if _plain(impl, "linear_scan", a, b, h0):
        y = ref.linear_scan(a, b, h0)
        return y, y[:, -1].float()
    return _scan.linear_scan(a.float().contiguous(), b.contiguous(),
                             h0.float().contiguous())


def page_transfer(src_pool, dst_pool, src_ids, dst_ids, *,
                  impl: str = "kernel"):
    """Batched cross-pool page-row transfer (disaggregated adoption).

    src_pool: [Ps, ...row]; dst_pool: [Pd, ...row] (same row shape and
    dtype, page counts may differ); src_ids / dst_ids: matching 1-D integer
    vectors — lane i copies row ``src_ids[i]`` into row ``dst_ids[i]``; -1
    on either side, or a ``dst_id`` past the pool, drops the lane; where
    live lanes share a destination the last one wins.  Updates ``dst_pool``
    in place and returns it; the copy is bitwise for every dtype.

    The two pools must not share storage: the card kernel copies lanes in
    parallel, so a transfer inside one pool would race (the cache's
    ``copy_pages`` is the in-pool copy).  Every row is taken, scale rows of
    64 bytes included: the TPU wrapper's tileability escape has no
    counterpart.
    """
    return page_transfer_leaves([(src_pool, dst_pool)], src_ids, dst_ids,
                                impl=impl)[0]


def page_transfer_leaves(pairs, src_ids, dst_ids, *, impl: str = "kernel"):
    """``page_transfer`` of one id vector through every (src_pool,
    dst_pool) pair of ``pairs`` (the pool leaves of an adoption: K, V and
    scale pools of every paged layer), each pair checked as
    ``page_transfer`` checks it.  On the card one launch moves every leaf
    (one a ``MAX_LEAVES`` chunk of the table), so no destination may
    overlap another pool of the list.  Returns the destination pools,
    updated in place."""
    for i, (src_pool, dst_pool) in enumerate(pairs):
        if tuple(src_pool.shape[1:]) != tuple(dst_pool.shape[1:]) \
                or src_pool.dtype != dst_pool.dtype:
            raise ValueError(
                f"page_transfer: pool rows do not match{_leaf(i, pairs)}: "
                f"src {tuple(src_pool.shape)} ({src_pool.dtype}) vs dst "
                f"{tuple(dst_pool.shape)} ({dst_pool.dtype})")
    src_ids = torch.as_tensor(src_ids)
    dst_ids = torch.as_tensor(dst_ids)
    if src_ids.shape != dst_ids.shape or src_ids.dim() != 1:
        raise ValueError(
            f"page_transfer: id vectors must be matching 1-D arrays, got "
            f"src_ids {tuple(src_ids.shape)} vs dst_ids "
            f"{tuple(dst_ids.shape)}")
    dsts = [dst for _, dst in pairs]
    if src_ids.shape[0] == 0 or not pairs:
        return dsts
    for i, (src_pool, dst_pool) in enumerate(pairs):
        if src_pool.untyped_storage().data_ptr() \
                == dst_pool.untyped_storage().data_ptr():
            raise ValueError(f"page_transfer: src_pool and dst_pool share "
                             f"storage{_leaf(i, pairs)}; a parallel copy "
                             f"inside one pool would race (use "
                             f"cache.copy_pages)")
    if len(pairs) > 1:
        _check_apart(pairs)
    if _plain(impl, "page_transfer", dsts[0], *(t for pair in pairs
                                                 for t in pair)):
        for src_pool, dst_pool in pairs:
            ref.page_transfer(src_pool, dst_pool, src_ids, dst_ids)
        return dsts
    dev = dsts[0].device
    return _xfer.page_transfer_leaves(
        pairs, src_ids.to(device=dev, dtype=torch.int32).contiguous(),
        dst_ids.to(device=dev, dtype=torch.int32).contiguous())


def _leaf(i: int, pairs) -> str:
    return f" (leaf {i})" if len(pairs) > 1 else ""


def _check_apart(pairs) -> None:
    """Raise if a destination pool's bytes overlap any other pool of
    ``pairs`` (sources may overlap each other: they are only read)."""
    spans = sorted((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size(),
                    is_dst) for pair in pairs
                   for t, is_dst in zip(pair, (False, True)) if t.numel())
    end_any = end_dst = -1
    for lo, hi, is_dst in spans:
        if lo < end_dst or (is_dst and lo < end_any):
            raise ValueError("page_transfer: a destination pool overlaps "
                             "another pool of the transfer; one launch "
                             "copies every leaf in parallel")
        end_any = max(end_any, hi)
        if is_dst:
            end_dst = max(end_dst, hi)


def _bank(kernel: str, key, pay) -> None:
    """Raise unless ``key`` is int32 [K] and ``pay`` is [K, ...]."""
    if key.dtype != torch.int32 or key.dim() != 1:
        raise ValueError(f"{kernel}: keys must be 1-D int32, got "
                         f"{key.dtype} {tuple(key.shape)}")
    if pay.dim() < 1 or pay.shape[0] != key.shape[0]:
        raise ValueError(f"{kernel}: payload {tuple(pay.shape)} does not "
                         f"have one row per key ({key.shape[0]})")


def lww_merge(key_a, pay_a, key_b, pay_b, *, impl: str = "kernel"):
    """LWW join of two register banks: per register the larger packed
    (clock, client) key wins and brings its payload row; on equal keys
    ``a`` wins.  key_*: int32 [K]; pay_*: [K, D] of one shape and dtype
    (any dtype: the card copies rows as bytes).  Returns new (key, pay).
    Nothing is padded: the JAX wrapper's 128-lane padding has no
    counterpart."""
    _bank("lww_merge", key_a, pay_a)
    _bank("lww_merge", key_b, pay_b)
    if key_a.shape != key_b.shape or pay_a.shape != pay_b.shape \
            or pay_a.dtype != pay_b.dtype:
        raise ValueError(
            f"lww_merge: banks do not match: a {tuple(pay_a.shape)} "
            f"({pay_a.dtype}) vs b {tuple(pay_b.shape)} ({pay_b.dtype})")
    if _plain(impl, "lww_merge", key_a, pay_a, pay_b):
        return ref.lww_merge(key_a, pay_a, key_b, pay_b)
    if key_a.shape[0] == 0:
        return key_a.clone(), pay_a.clone()
    return _lww.lww_merge(key_a.contiguous(), pay_a.contiguous(),
                          key_b.contiguous(), pay_b.contiguous())


def delta_apply(key, pay, d_idx, d_key, d_pay, *, impl: str = "kernel"):
    """Scatter-apply an LWW delta buffer into a register bank.

    key: int32 [K]; pay: [K, D]; d_idx, d_key: int32 [Dc]; d_pay: [Dc, D],
    cast to ``pay``'s dtype.  Lane ``j`` writes register ``d_idx[j]`` where
    ``d_key[j]`` is strictly greater than the bank's key; a ``d_idx``
    outside [0, K) (-1 by convention) is an empty lane.  Where lanes share
    a target, the largest key wins, then the lowest lane
    (``ref.delta_apply``).  Returns new (key, pay).
    """
    _bank("delta_apply", key, pay)
    _bank("delta_apply", d_key, d_pay)
    if d_idx.dtype != torch.int32 or d_idx.shape != d_key.shape:
        raise ValueError(f"delta_apply: d_idx must be int32 "
                         f"{tuple(d_key.shape)}, got {d_idx.dtype} "
                         f"{tuple(d_idx.shape)}")
    if d_pay.shape[1:] != pay.shape[1:]:
        raise ValueError(f"delta_apply: lane rows {tuple(d_pay.shape[1:])} "
                         f"do not match bank rows {tuple(pay.shape[1:])}")
    if _plain(impl, "delta_apply", key, pay, d_pay):
        return ref.delta_apply(key, pay, d_idx, d_key, d_pay)
    if key.shape[0] == 0:
        return key.clone(), pay.clone()
    if key.shape[0] >= 2 ** 31:
        raise ValueError("delta_apply: the kernel takes K < 2^31 registers")
    return _delta.delta_apply(key.contiguous(), pay.contiguous(),
                              d_idx.contiguous(), d_key.contiguous(),
                              d_pay.to(pay.dtype).contiguous())
