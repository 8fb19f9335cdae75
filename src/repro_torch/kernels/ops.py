"""Public wrappers around the port's kernels: attention and the RG-LRU's
linear recurrence.

Each wrapper applies the contract of its ``repro.kernels.ops`` counterpart
on every path, then dispatches by device:

  * a CPU tensor takes the plain PyTorch version in ``ref``;
  * a CUDA tensor launches the Hopper kernel, or raises — there is no
    fallback.

``impl="ref"`` asks for the plain version on any device: the model's plain
path, which ``chip_smoke.py`` holds the kernel path against on the card
(the JAX wrappers' ``use_pallas=False``).

The paged pools are updated in place and never padded per step; the TPU
tileability guard and 128-lane padding of the JAX wrappers have no
counterpart here.

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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import linear_scan as _scan
from repro_torch.kernels import paged_chunk_attention as _pchunk
from repro_torch.kernels import paged_chunk_attention_quant as _pchunk_q
from repro_torch.kernels import paged_decode_attention as _pdec
from repro_torch.kernels import paged_decode_attention_quant as _pdec_q
from repro_torch.kernels import paged_mla_chunk as _mchunk
from repro_torch.kernels import paged_mla_chunk_quant as _mchunk_q
from repro_torch.kernels import paged_mla_decode as _mdec
from repro_torch.kernels import paged_mla_decode_quant as _mdec_q
from repro_torch.kernels import ref

KERNELS = {"decode_attention": _dec, "paged_decode_attention": _pdec,
           "paged_chunk_attention": _pchunk,
           "paged_decode_attention_quant": _pdec_q,
           "paged_chunk_attention_quant": _pchunk_q,
           "paged_mla_decode": _mdec, "paged_mla_chunk": _mchunk,
           "paged_mla_decode_quant": _mdec_q,
           "paged_mla_chunk_quant": _mchunk_q, "linear_scan": _scan}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0


def _plain(x: torch.Tensor, impl: str) -> bool:
    """True where the plain version runs: asked for, or a CPU tensor."""
    if impl == "ref":
        return True
    if impl != "kernel":
        raise ValueError(f"impl must be 'kernel' or 'ref', got {impl!r}")
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for tensors on {x.device}")


def decode_attention(q, k, v, kv_len, *, scale: float | None = None,
                     impl: str = "kernel"):
    """q: [B, Hq, D]; k, v: [B, Hkv, S, D]; kv_len: i32[B] -> [B, Hq, D]."""
    if _plain(q, impl):
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
    if _plain(q, impl):
        return ref.paged_decode_attention(q, k_pages, v_pages, block_tables,
                                          pos, k_new, v_new, scale=scale,
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
    if _plain(q, impl):
        return ref.paged_chunk_attention(q, k_pages, v_pages, block_tables,
                                         start, span, k_new, v_new,
                                         scale=scale, window=window)
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
    if _plain(q, impl):
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
    if _plain(q, impl):
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


def _mla_q(q_abs, q_rope) -> torch.Tensor:
    """The kernels' query: concat(q_abs, q_rope) in float32, one
    contraction over the latent row's r + rd live features."""
    return torch.cat([q_abs.float(), q_rope.float()], dim=-1).contiguous()


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
    if _plain(q_abs, impl):
        return ref.paged_mla_decode(q_abs, q_rope, latent_pages,
                                    block_tables, pos, latent_new, r=r,
                                    scale=scale)
    return _mdec.paged_mla_decode(
        _mla_q(q_abs, q_rope), latent_pages,
        block_tables.to(torch.int32).contiguous(),
        pos.to(torch.int32).contiguous(), latent_new.contiguous(), r=r,
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
    if _plain(q_abs, impl):
        return ref.paged_mla_chunk(q_abs, q_rope, latent_pages,
                                   block_tables, start, span, latent_new,
                                   r=r, scale=scale)
    return _mchunk.paged_mla_chunk(
        _mla_q(q_abs, q_rope), latent_pages,
        block_tables.to(torch.int32).contiguous(),
        start.to(torch.int32).contiguous(), span.to(torch.int32).contiguous(),
        latent_new.contiguous(), r=r, scale=scale)


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
    if _plain(q_abs, impl):
        return ref.paged_mla_decode_quant(
            q_abs, q_rope, latent_pages, latent_scales, block_tables, pos,
            latent_new, r=r, scale=scale)
    return _mdec_q.paged_mla_decode_quant(
        _mla_q(q_abs, q_rope), latent_pages, latent_scales,
        block_tables.to(torch.int32).contiguous(),
        pos.to(torch.int32).contiguous(), latent_new.contiguous(), r=r,
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
    if _plain(q_abs, impl):
        return ref.paged_mla_chunk_quant(
            q_abs, q_rope, latent_pages, latent_scales, block_tables, start,
            span, latent_new, r=r, scale=scale)
    return _mchunk_q.paged_mla_chunk_quant(
        _mla_q(q_abs, q_rope), latent_pages, latent_scales,
        block_tables.to(torch.int32).contiguous(),
        start.to(torch.int32).contiguous(), span.to(torch.int32).contiguous(),
        latent_new.contiguous(), r=r, scale=scale)


def linear_scan(a, b, h0, *, impl: str = "kernel"):
    """h_t = a_t ⊙ h_{t-1} + b_t.  a, b: [B, T, D]; h0: [B, D].  Returns
    (y [B, T, D] in b's dtype, h_T [B, D] float32).

    The plain path returns y's last step as h_T, as JAX's
    ``use_pallas=False`` does (the float32 carry itself when b is float32,
    as on the model's path); the kernel returns the float32 carry, as JAX's
    Pallas kernel does.  Time is not padded with identity steps: the
    kernel walks t < T.
    """
    if _plain(a, impl):
        y = ref.linear_scan(a, b, h0)
        return y, y[:, -1].float()
    return _scan.linear_scan(a.float().contiguous(), b.contiguous(),
                             h0.float().contiguous())
