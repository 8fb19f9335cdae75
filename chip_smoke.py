#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and check it end to end.

    python3 chip_smoke.py          # from the repository root

1. builds the eleven kernels from ``src/repro_torch/kernels/csrc`` (one
   nvcc per source, started together);
2. holds each kernel against its plain PyTorch version on the card at the
   workloads' shapes and times kernel, plain version, and the PyTorch
   library call where one computes the same function: the five MHA kernels
   at OLMo-1B's (bf16, 16 heads of 128, page size 16, batch 8, contexts up
   to 1024, chunk 64, ragged rows, -1 and trash-page table entries; the
   two quantized-pool kernels for int8 and fp8 pools), the four paged-MLA
   kernels at DeepSeek-V2-Lite's (16 heads over a 512 + 64 latent row,
   pool rows of 640; bf16, int8 and fp8 pools), ``decode_attention`` also
   at RecurrentGemma-2B's local attention (10 query heads on 1 KV head of
   256), ``linear_scan`` at its RG-LRU's (batch 8, width 2560: the
   mixed step's 64 steps with ragged identity-padded rows, prefill's 128)
   and ``page_transfer`` bitwise on every pool leaf adoption moves (OLMo's
   bf16 / int8 / fp8 rows and f32 scales, MLA's latent rows and scales;
   one lane and 64 with -1 lanes, out-of-range and repeated destinations,
   pools of 513 and 400 pages);
3. serves ``olmo-1b`` at full width with seeded random bf16 weights:
   ``ContinuousBatchingEngine`` answers 16 requests (bf16 pools, then int8
   pools), ``Engine.generate`` decodes on a dense and on a paged cache;
   each path runs once through the kernels (launch counts must be > 0) and
   once through the plain versions, and the two must agree;
4. runs the CodeCRDT agent trial (``agents/orchestrator.run_task``) on
   ``olmo-1b`` at full width, 4 agents on ``dashboard``: (a) parallel,
   paged, chunked, int8 pools, allgather merge; (b) as (a) with the delta
   merge; (c) as (a), sequential; (d) parallel on the dense cache with
   token-by-token replay.  Every run must converge; (a) and (b) must give
   the same document and (b) ship fewer bytes; from one mid-trial state of
   (a), captured in a fifth, untimed run, a mixed step runs through the
   kernels and through the plain versions, layer by layer from the same
   inputs (pools bitwise but for the trash page) and end to end (logits);
   then disaggregated serving (``workload.DISAGG``: one prefill and one
   decode engine on a replicated page table, sharing OLMo's parameters):
   adoption on through the kernels, off, on through the plain versions, on
   int8 pools, and an exporter crash mid-transfer (3 replicas); every run
   answers its 8 requests and converges, the first adopted page equals the
   exporter's bitwise in every layer and leaf, the adoption counters agree
   across paths, streams agree but at near-ties, and the crash run aborts,
   rolls back and completes every request exactly once; then trial run
   (g), (a) on two page-table replicas with disaggregated homes;
5. serves the MLA workload (``workload.mla_config()``: DeepSeek-V2-Lite at
   full width with dense FFNs, seeded random bf16 weights): the scheduler
   on bf16 and int8 latent pools, ``Engine.generate`` on dense and paged
   latent caches, the first-step logits of the paged routes against the
   plain path; then trial run (e), (a)'s configuration on that model;
6. serves ``recurrentgemma-2b`` at full width (``workload.RECURRENT_ARCH``,
   seeded random bf16 weights; the MLA model freed first): the scheduler
   through the kernels and through the plain versions, ``Engine.generate``
   on a dense and a paged cache, the first-step logits of decode and of a
   mixed step against the plain path, one mid-run scheduler step layer by
   layer from the same inputs (each recurrent layer's h and conv state
   against the plain path's), then trial run (f), (a)'s configuration on
   that model without int8 (no layer of it holds a pool to quantize).

Every line before the last is one JSON object; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit
code is non-zero and that line is never printed.  Without a CUDA card the
script exits with code 2 before doing anything.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

from repro_torch.launch import workload  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12          # dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12            # float32 outside the tensor cores
# Kernel against plain version, bf16 outputs: both round a float32 result
# to bf16, and the float32 results differ in their last bits, so they may
# land one bf16 step (2^-8 relative, within 2^-7 of |x|) apart.  The atol
# covers sum-order differences at outputs near 0; the measured errors at
# these shapes were 2e-3, 1.2e-4 and 5e-4 (PERF.md).
KERNEL_ATOL, KERNEL_RTOL = 4e-3, 2 ** -7
# Logits after 16 bf16 layers: the kernel and plain paths differ by bf16
# rounding of the attention output, amplified through the residual stream.
LOGITS_ATOL = 0.25

# OLMo-1B attention shapes on the main path.
H, D = 16, 128
B, PS, MAX_LEN, CHUNK = (workload.ENGINE[k] for k in (
    "batch", "page_size", "max_len", "chunk_size"))

# The agent trial at full width (phase 4).
TRIAL = dict(n_agents=4, kv="paged", prefill="chunked", page_size=16,
             chunk_size=32, max_len=1024, kv_quant="int8")
TRIAL_TASK = "dashboard"
STEP_VALVE = 20_000


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events over ``iters``."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(fn, match: str, iters: int = 20) -> float:
    """Mean device time in ms of the kernels whose name holds ``match``
    over ``iters`` calls of ``fn``, read from torch.profiler: for a kernel
    shorter than its wrapper's host work, events around the calls time the
    host instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and match in e.key)
    if total_us <= 0:
        fail(f"the profiler saw no kernel named like {match!r}")
    return total_us / iters / 1e3


def bound(nbytes: float, flops: float,
          peak: float = BF16_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def close(a, b) -> tuple[float, bool]:
    err = (a.float() - b.float()).abs()
    ok = bool((err <= KERNEL_ATOL + KERNEL_RTOL * b.float().abs()).all())
    return float(err.max()), ok


# ---------------------------------------------------------------------------
# Kernels against their plain versions
# ---------------------------------------------------------------------------

def _tables(rng, lens, trash):
    """Block tables for rows holding ``lens`` tokens: live pages drawn from
    a shuffled pool, unallocated slots on the trash page, and row 1's tail
    left at -1 (an unallocated table the kernels must drop writes to)."""
    maxp = MAX_LEN // PS
    perm = rng.permutation(B * maxp)
    bt = np.full((B, maxp), trash, np.int32)
    used = 0
    for b, n in enumerate(lens):
        k = -(-int(n) // PS)
        bt[b, :k] = perm[used:used + k]
        used += k
    bt[1, -(-int(lens[1]) // PS):] = -1
    return bt


def _paged_case(rng, lens):
    maxp = MAX_LEN // PS
    trash = B * maxp
    kp = torch.randn((trash + 1, H, PS, D), device="cuda").bfloat16()
    vp = torch.randn((trash + 1, H, PS, D), device="cuda").bfloat16()
    bt = torch.as_tensor(_tables(rng, lens, trash), device="cuda")
    return kp, vp, bt, trash


def _pools_equal(a, b, trash) -> bool:
    """Bitwise, every page but the trash page (its contents are
    unspecified when several rows write it); int8 / fp8 pools compare
    their bytes."""
    if a.element_size() == 1:
        a, b = a.view(torch.uint8), b.view(torch.uint8)
    return torch.equal(a[:trash], b[:trash])


def _quant_case(rng, lens, qdtype):
    """[k_pages, k_scales, v_pages, v_scales] (the wrappers' order): pools
    holding quantized random rows and their f32 scales, and tables as
    ``_paged_case``'s."""
    from repro_torch.kernels import ref
    kp, vp, bt, trash = _paged_case(rng, lens)
    kq, ks = ref.quantize_rows(kp, qdtype)
    vq, vs = ref.quantize_rows(vp, qdtype)
    return [kq, ks, vq, vs], bt, trash


def quant_kernel_rows(rng):
    """The two quantized-pool kernels against their plain versions, int8
    and fp8, at the shapes of the float kernels' checks.  The row reports
    the int8 pools (the trial's); fp8 adds its own error and times."""
    from repro_torch.kernels import ops
    scale = D ** -0.5
    rows = []
    start = np.array([0, 100, 300, 447, 700, 900, 959, 64])
    span = np.array([64, 64, 1, 1, 0, 30, 64, 17])
    pos = np.array([1023, 17, 300, 511, 640, 5, 999, 128])
    specs = {
        "paged_chunk_attention_quant": dict(
            lens=start + span, qshape=(B, H, CHUNK, D), kvshape=(B, H, CHUNK, D),
            idx=(torch.as_tensor(start, dtype=torch.int32, device="cuda"),
                 torch.as_tensor(span, dtype=torch.int32, device="cuda")),
            op=ops.paged_chunk_attention_quant,
            source="src/repro_torch/kernels/csrc/paged_chunk_attention_quant.cu",
            replaces="src/repro/kernels/paged_chunk_attention.py:389"),
        "paged_decode_attention_quant": dict(
            lens=pos + 1, qshape=(B, H, D), kvshape=(B, H, D),
            idx=(torch.as_tensor(pos, dtype=torch.int32, device="cuda"),),
            op=ops.paged_decode_attention_quant,
            source="src/repro_torch/kernels/csrc/paged_decode_attention_quant.cu",
            replaces="src/repro/kernels/paged_decode_attention.py:355"),
    }
    for name, sp in specs.items():
        row = dict(name=name, route="cuda", source=sp["source"],
                   replaces=sp["replaces"], library_ms=None)
        q = torch.randn(sp["qshape"], device="cuda").bfloat16()
        kn = torch.randn(sp["kvshape"], device="cuda").bfloat16()
        vn = torch.randn(sp["kvshape"], device="cuda").bfloat16()
        for qname, qdtype in (("int8", torch.int8),
                              ("fp8", torch.float8_e4m3fn)):
            pools, bt, trash = _quant_case(rng, sp["lens"], qdtype)
            twin = [t.clone() for t in pools]
            o1 = sp["op"](q, *pools, bt, *sp["idx"], kn, vn,
                          scale=scale)[0]
            o2 = sp["op"](q, *twin, bt, *sp["idx"], kn, vn,
                          scale=scale, impl="ref")[0]
            if len(sp["idx"]) == 2:         # chunk: defined at j < span
                live = (torch.arange(CHUNK, device="cuda")[None, :]
                        < sp["idx"][1][:, None])[:, None, :, None]
                o1, o2 = torch.where(live, o1, 0), torch.where(live, o2, 0)
            err, ok = close(o1, o2)
            bitwise = all(_pools_equal(a, b, trash)
                          for a, b in zip(pools, twin))
            if not (ok and bitwise):
                fail(f"{name} ({qname}) disagrees: max_abs_err {err}, pools "
                     f"and scales bitwise {bitwise}")
            # Timed through the wrapper, as the model calls it.
            ms = cuda_ms(lambda: sp["op"](q, *pools, bt, *sp["idx"], kn, vn,
                                          scale=scale))
            plain_ms = cuda_ms(lambda: sp["op"](q, *twin, bt, *sp["idx"],
                                                kn, vn, scale=scale,
                                                impl="ref"))
            if qname == "int8":
                row.update(shapes=f"q{list(sp['qshape'])} bf16, int8 pools "
                                  f"[{trash + 1},{H},{PS},{D}] + f32 scales",
                           max_abs_err=err, pools_bitwise=bitwise, ms=ms,
                           plain_ms=plain_ms)
            else:
                row.update(fp8_max_abs_err=err, fp8_pools_bitwise=bitwise,
                           fp8_ms=ms, fp8_plain_ms=plain_ms)
        # Bytes the function must move, one byte per pool value plus 4 B of
        # scale per pool row: the cached K/V rows of rows that attend, the
        # new rows read at their dtype (bf16) and written quantized once, q
        # read and out written at the defined queries, and the live table
        # entries.
        if len(sp["idx"]) == 2:
            run = span > 0
            old, new = int(start[run].sum()), int(span.sum())
            pages = int(sum(-(-int(n) // PS) for n in (start + span)[run]))
            qk = int(sum(s_ * st_ + s_ * (s_ + 1) // 2
                         for s_, st_ in zip(span, start)))
            nidx = 2 * B * 4
        else:
            old, new = int(pos.sum()), B
            pages = int(sum(-(-int(n) // PS) for n in pos + 1))
            qk = int((pos + 1).sum())
            nidx = B * 4
        row_bytes = D * 1 + 4
        nbytes = (2 * old * H * row_bytes
                  + 2 * new * H * D * kn.element_size()
                  + 2 * new * H * row_bytes + 2 * new * H * D * 2
                  + pages * 4 + nidx)
        row["bound_ms"], row["bound_by"] = bound(nbytes, 4 * qk * H * D)
        rows.append(row)
    return rows


# DeepSeek-V2-Lite's MLA widths (workload.mla_config()): 16 heads over a
# latent row of r = 512 (ckv) + rd = 64 (krope), padded to Dp = 640 in the
# pool; the absorbed queries and the contexts are float32.
MLA_R, MLA_RD, MLA_DP = 512, 64, 640
# MLA kernel against plain version: float32 contexts from the same float32
# products, summed in another order.
MLA_ATOL, MLA_RTOL = 1e-5, 1e-5


def mla_close(a, b) -> tuple[float, bool]:
    err = (a - b).abs()
    return float(err.max()), bool((err <= MLA_ATOL + MLA_RTOL * b.abs()).all())


def mla_kernel_rows(rng):
    """The four paged-MLA kernels against their plain versions at the
    workload's shapes: bf16 pools for the float pair, int8 (and fp8, an
    extra error and time) for the ``_quant`` pair; ragged rows, -1 and
    trash-page table entries.  Timed through ``ops``, as the model calls
    them (the wrapper's concat of q_abs and q_rope into one float32 q
    included)."""
    from repro_torch.kernels import ops, ref
    scale = (128 + MLA_RD) ** -0.5
    lw = MLA_R + MLA_RD
    start = np.array([0, 100, 300, 447, 700, 900, 959, 64])
    span = np.array([64, 64, 1, 1, 0, 30, 64, 17])
    pos = np.array([1023, 17, 300, 511, 640, 5, 999, 128])
    chunk_idx = (torch.as_tensor(start, dtype=torch.int32, device="cuda"),
                 torch.as_tensor(span, dtype=torch.int32, device="cuda"))
    dec_idx = (torch.as_tensor(pos, dtype=torch.int32, device="cuda"),)
    src = "src/repro_torch/kernels/csrc/"
    specs = [
        ("paged_mla_chunk", chunk_idx, start + span, (B, H, CHUNK),
         "paged_chunk_attention.py:531"),
        ("paged_mla_decode", dec_idx, pos + 1, (B, H),
         "paged_mla_decode.py:136"),
        ("paged_mla_chunk_quant", chunk_idx, start + span, (B, H, CHUNK),
         "paged_chunk_attention.py:695"),
        ("paged_mla_decode_quant", dec_idx, pos + 1, (B, H),
         "paged_mla_decode.py:270")]
    rows = []
    for name, idx, lens, qs, tpu in specs:
        quant = name.endswith("_quant")
        op = getattr(ops, name)
        q_abs = torch.randn(qs + (MLA_R,), device="cuda")
        q_rope = torch.randn(qs + (MLA_RD,), device="cuda")
        new_shape = (B, CHUNK, MLA_DP) if len(qs) == 3 else (B, MLA_DP)
        new = torch.randn(new_shape, device="cuda").bfloat16()
        new[..., lw:] = 0                       # the model's pad columns
        bt = torch.as_tensor(_tables(rng, lens, B * (MAX_LEN // PS)),
                             device="cuda")
        trash = B * (MAX_LEN // PS)
        row = dict(name=name, route="cuda", source=f"{src}{name}.cu",
                   replaces=f"src/repro/kernels/{tpu}", library_ms=None)
        for qname, qdtype in ((("int8", torch.int8),
                               ("fp8", torch.float8_e4m3fn)) if quant
                              else (("bf16", torch.bfloat16),)):
            pool = torch.randn((trash + 1, PS, MLA_DP), device="cuda")
            pools = (list(ref.quantize_rows(pool, qdtype)) if quant
                     else [pool.bfloat16()])
            twin = [t.clone() for t in pools]
            c1 = op(q_abs, q_rope, *pools, bt, *idx, new, scale=scale)[0]
            c2 = op(q_abs, q_rope, *twin, bt, *idx, new, scale=scale,
                    impl="ref")[0]
            if len(idx) == 2:               # chunk: defined at j < span
                live = (torch.arange(CHUNK, device="cuda")[None, :]
                        < idx[1][:, None])[:, None, :, None]
                c1, c2 = torch.where(live, c1, 0), torch.where(live, c2, 0)
            err, ok = mla_close(c1, c2)
            bitwise = all(_pools_equal(a, b, trash)
                          for a, b in zip(pools, twin))
            if not (ok and bitwise):
                fail(f"{name} ({qname}) disagrees: max_abs_err {err}, pools "
                     f"and scales bitwise {bitwise}")
            ms = cuda_ms(lambda: op(q_abs, q_rope, *pools, bt, *idx, new,
                                    scale=scale))
            plain_ms = cuda_ms(lambda: op(q_abs, q_rope, *twin, bt, *idx,
                                          new, scale=scale, impl="ref"))
            if qname == "fp8":
                row.update(fp8_max_abs_err=err, fp8_pools_bitwise=bitwise,
                           fp8_ms=ms, fp8_plain_ms=plain_ms)
            else:
                row.update(shapes=f"q_abs{list(q_abs.shape)} + q_rope f32, "
                                  f"{qname} pool [{trash + 1},{PS},{MLA_DP}]"
                                  + (" + f32 scales" if quant else ""),
                           max_abs_err=err, pools_bitwise=bitwise, ms=ms,
                           plain_ms=plain_ms)
        # Bytes the function must move: the live r + rd columns of the
        # cached rows that queries attend (one byte plus 4 B of scale per
        # row for a quantized pool), the new Dp-wide rows read at their
        # dtype (bf16) and written once, q read and ctx written in float32
        # at the defined queries, and the live table entries.  Operations:
        # 2·(L + r) per (query head, attended row).
        if len(idx) == 2:
            run = span > 0
            old, nnew = int(start[run].sum()), int(span.sum())
            pages = int(sum(-(-int(n) // PS) for n in (start + span)[run]))
            pairs = int(sum(s_ * st_ + s_ * (s_ + 1) // 2
                            for s_, st_ in zip(span, start)))
            nidx = 2 * B * 4
        else:
            old, nnew = int(pos.sum()), B
            pages = int(sum(-(-int(n) // PS) for n in pos + 1))
            pairs = int((pos + 1).sum())
            nidx = B * 4
        cached = lw + 4 if quant else lw * 2
        written = MLA_DP + 4 if quant else MLA_DP * 2
        nbytes = (old * cached + nnew * (MLA_DP * 2 + written)
                  + nnew * H * (lw + MLA_R) * 4 + pages * 4 + nidx)
        row["bound_ms"], row["bound_by"] = bound(
            nbytes, 2 * pairs * H * (lw + MLA_R))
        rows.append(row)
    return rows


def kernel_phase():
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_chunk_attention as kchunk
    from repro_torch.kernels import paged_decode_attention as kpdec
    rng = np.random.default_rng(0)
    scale = D ** -0.5
    rows = []

    # paged_chunk_attention: prompt chunks and decode rows in one step.
    start = np.array([0, 100, 300, 447, 700, 900, 959, 64])
    span = np.array([64, 64, 1, 1, 0, 30, 64, 17])
    kp, vp, bt, trash = _paged_case(rng, start + span)
    q = torch.randn((B, H, CHUNK, D), device="cuda").bfloat16()
    kn = torch.randn((B, H, CHUNK, D), device="cuda").bfloat16()
    vn = torch.randn((B, H, CHUNK, D), device="cuda").bfloat16()
    st = torch.as_tensor(start, dtype=torch.int32, device="cuda")
    sp = torch.as_tensor(span, dtype=torch.int32, device="cuda")
    kp2, vp2 = kp.clone(), vp.clone()
    o1, _, _ = ops.paged_chunk_attention(q, kp, vp, bt, st, sp, kn, vn,
                                         scale=scale)
    o2, _, _ = ref.paged_chunk_attention(q, kp2, vp2, bt, st, sp, kn, vn,
                                         scale=scale)
    live = (torch.arange(CHUNK, device="cuda")[None, :]
            < sp[:, None])[:, None, :, None]
    err, ok = close(torch.where(live, o1, 0), torch.where(live, o2, 0))
    bitwise = _pools_equal(kp, kp2, trash) and _pools_equal(vp, vp2, trash)
    if not (ok and bitwise):
        fail(f"paged_chunk_attention disagrees: max_abs_err {err}, pools "
             f"bitwise {bitwise}")
    # Bytes the function must move: the cached K/V that rows with a span
    # attend over (start keys each), the span's K/V read from k/v_new and
    # written to the pools once, q read and out written at the span's
    # queries, and those rows' live table entries.
    run = span > 0
    old, new = int(start[run].sum()), int(span.sum())
    pages = int(sum(-(-int(n) // PS) for n in (start + span)[run]))
    nbytes = (2 * old * H * D * 2 + 2 * 2 * new * H * D * 2
              + 2 * new * H * D * 2 + pages * 4 + 2 * B * 4)
    qk = int(sum(s * st_ + s * (s + 1) // 2 for s, st_ in zip(span, start)))
    flops = 4 * qk * H * D
    bms, by = bound(nbytes, flops)
    rows.append(dict(
        name="paged_chunk_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_chunk_attention.cu",
        replaces="src/repro/kernels/paged_chunk_attention.py:196",
        shapes=f"q[{B},{H},{CHUNK},{D}] bf16, pools[{trash + 1},{H},{PS},"
               f"{D}], start {start.tolist()}, span {span.tolist()}",
        max_abs_err=err, pools_bitwise=bitwise,
        ms=cuda_ms(lambda: kchunk.paged_chunk_attention(
            q, kp, vp, bt, st, sp, kn, vn, scale=scale)),
        plain_ms=cuda_ms(lambda: ref.paged_chunk_attention(
            q, kp2, vp2, bt, st, sp, kn, vn, scale=scale)),
        bound_ms=bms, bound_by=by, library_ms=None))

    # paged_decode_attention: one token per row at ragged positions.
    pos = np.array([1023, 17, 300, 511, 640, 5, 999, 128])
    kp, vp, bt, trash = _paged_case(rng, pos + 1)
    q = torch.randn((B, H, D), device="cuda").bfloat16()
    kn = torch.randn((B, H, D), device="cuda").bfloat16()
    vn = torch.randn((B, H, D), device="cuda").bfloat16()
    ps_ = torch.as_tensor(pos, dtype=torch.int32, device="cuda")
    kp2, vp2 = kp.clone(), vp.clone()
    o1, _, _ = ops.paged_decode_attention(q, kp, vp, bt, ps_, kn, vn,
                                          scale=scale)
    o2, _, _ = ref.paged_decode_attention(q, kp2, vp2, bt, ps_, kn, vn,
                                          scale=scale)
    err, ok = close(o1, o2)
    bitwise = _pools_equal(kp, kp2, trash) and _pools_equal(vp, vp2, trash)
    if not (ok and bitwise):
        fail(f"paged_decode_attention disagrees: max_abs_err {err}, pools "
             f"bitwise {bitwise}")
    # The pos cached keys, the new token's K/V read and written once, q
    # and out, and the live table entries.
    pages = int(sum(-(-int(n) // PS) for n in pos + 1))
    nbytes = (2 * int(pos.sum()) * H * D * 2 + 2 * 2 * B * H * D * 2
              + 2 * q.numel() * 2 + pages * 4 + B * 4)
    bms, by = bound(nbytes, 4 * int((pos + 1).sum()) * H * D)
    rows.append(dict(
        name="paged_decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_decode_attention.cu",
        replaces="src/repro/kernels/paged_decode_attention.py:179",
        shapes=f"q[{B},{H},{D}] bf16, pools[{trash + 1},{H},{PS},{D}], "
               f"pos {pos.tolist()}",
        max_abs_err=err, pools_bitwise=bitwise,
        ms=cuda_ms(lambda: kpdec.paged_decode_attention(
            q, kp, vp, bt, ps_, kn, vn, scale=scale)),
        plain_ms=cuda_ms(lambda: ref.paged_decode_attention(
            q, kp2, vp2, bt, ps_, kn, vn, scale=scale)),
        bound_ms=bms, bound_by=by, library_ms=None))

    # decode_attention: dense [B, H, 1024, D] cache, ragged kv_len.
    kv_len = np.array([1024, 18, 301, 512, 641, 6, 1000, 129])
    q = torch.randn((B, H, D), device="cuda").bfloat16()
    k = torch.randn((B, H, MAX_LEN, D), device="cuda").bfloat16()
    v = torch.randn((B, H, MAX_LEN, D), device="cuda").bfloat16()
    kl = torch.as_tensor(kv_len, dtype=torch.int32, device="cuda")
    o1 = ops.decode_attention(q, k, v, kl, scale=scale)
    o2 = ref.decode_attention(q, k, v, kl, scale=scale)
    err, ok = close(o1, o2)
    if not ok:
        fail(f"decode_attention disagrees: max_abs_err {err}")
    mask = (torch.arange(MAX_LEN, device="cuda")[None, :]
            < kl[:, None])[:, None, None, :]
    lib = torch.nn.functional.scaled_dot_product_attention
    o3 = lib(q[:, :, None], k, v, attn_mask=mask, scale=scale)[:, :, 0]
    lib_err, lib_ok = close(o3, o2)
    if not lib_ok:
        fail(f"the SDPA yardstick computes another function: {lib_err}")
    keys = int(kv_len.sum())
    bms, by = bound(2 * keys * H * D * 2 + 2 * q.numel() * 2 + B * 4,
                    4 * keys * H * D)
    rows.append(dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:95",
        shapes=f"q[{B},{H},{D}] bf16, k/v[{B},{H},{MAX_LEN},{D}], kv_len "
               f"{kv_len.tolist()}",
        max_abs_err=err, pools_bitwise=None,
        ms=cuda_ms(lambda: kdec.decode_attention(q, k, v, kl, scale=scale)),
        plain_ms=cuda_ms(lambda: ref.decode_attention(q, k, v, kl,
                                                      scale=scale)),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(lambda: lib(q[:, :, None], k, v, attn_mask=mask,
                                       scale=scale))))
    rows[-1].update(decode_attention_d256(rng))
    rows += quant_kernel_rows(rng)
    rows += mla_kernel_rows(rng)
    rows.append(linear_scan_row(rng))
    rows.append(page_transfer_row(rng))
    return rows


# RecurrentGemma-2B's shapes (workload.RECURRENT_ARCH): local attention of
# 10 query heads on 1 KV head of 256 over a dense cache of max_len keys;
# the RG-LRU of width 2560.
RG_HQ, RG_HKV, RG_D, RG_W = 10, 1, 256, 2560


def decode_attention_d256(rng) -> dict:
    """``decode_attention`` at the recurrent model's local-attention
    shapes (its head_dim 256 tiles in dynamic shared memory): held to the
    plain version under the bf16 rule, timed against it and SDPA; the
    bound counts the valid prefixes' K/V."""
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import ops, ref
    scale = RG_D ** -0.5
    kv_len = np.array([1024, 18, 301, 512, 641, 6, 1000, 129])
    q = torch.randn((B, RG_HQ, RG_D), device="cuda").bfloat16()
    k = torch.randn((B, RG_HKV, MAX_LEN, RG_D), device="cuda").bfloat16()
    v = torch.randn((B, RG_HKV, MAX_LEN, RG_D), device="cuda").bfloat16()
    kl = torch.as_tensor(kv_len, dtype=torch.int32, device="cuda")
    o1 = ops.decode_attention(q, k, v, kl, scale=scale)
    o2 = ref.decode_attention(q, k, v, kl, scale=scale)
    err, ok = close(o1, o2)
    if not ok:
        fail(f"decode_attention (head_dim 256, MQA) disagrees: max_abs_err "
             f"{err}")
    mask = (torch.arange(MAX_LEN, device="cuda")[None, :]
            < kl[:, None])[:, None, None, :]
    lib = torch.nn.functional.scaled_dot_product_attention
    kx, vx = (t.expand(-1, RG_HQ, -1, -1) for t in (k, v))
    lib_err, lib_ok = close(lib(q[:, :, None], kx, vx, attn_mask=mask,
                                scale=scale)[:, :, 0], o2)
    if not lib_ok:
        fail(f"the SDPA yardstick computes another function: {lib_err}")
    keys = int(kv_len.sum())
    bms, by = bound(2 * keys * RG_HKV * RG_D * 2 + 2 * q.numel() * 2 + B * 4,
                    4 * keys * RG_HQ * RG_D)
    return dict(
        d256_shapes=f"q[{B},{RG_HQ},{RG_D}] bf16, k/v[{B},{RG_HKV},"
                    f"{MAX_LEN},{RG_D}], kv_len {kv_len.tolist()}",
        d256_max_abs_err=err,
        d256_ms=cuda_ms(lambda: kdec.decode_attention(q, k, v, kl,
                                                      scale=scale)),
        d256_plain_ms=cuda_ms(lambda: ref.decode_attention(q, k, v, kl,
                                                           scale=scale)),
        d256_bound_ms=bms, d256_bound_by=by,
        d256_library_ms=cuda_ms(lambda: lib(q[:, :, None], kx, vx,
                                            attn_mask=mask, scale=scale)))


# linear_scan against its plain version: both round each step once (the
# kernel's FMA, the plain version's float64 step rounded to float32), so
# bitwise is expected; elements that differ are counted and held to 1e-6
# of max |y| (a float64 sum rounded twice may, rarely, land one float32
# step away).
SCAN_RTOL = 1e-6


def linear_scan_row(rng) -> dict:
    """``linear_scan`` at the mixed step's [8, 64, 2560] (ragged spans,
    identity steps past each: the model's padding) and at prefill's
    [8, 128, 2560]; float32 a and b, as on the model's path.  The bound
    counts a and b read, y written, h0 read and h_T written, float32.
    ``ms`` is the kernel's device time (the profiler's): its wrapper's
    host work takes longer, so events around the calls (``wrapper_ms``)
    time the host."""
    from repro_torch.kernels import linear_scan as kscan
    from repro_torch.kernels import ops
    row = dict(name="linear_scan", route="cuda",
               source="src/repro_torch/kernels/csrc/linear_scan.cu",
               replaces="src/repro/kernels/rglru_scan.py:67",
               library_ms=None, pools_bitwise=None)
    span = torch.as_tensor([64, 64, 1, 1, 0, 30, 64, 17], device="cuda")
    for name, t in (("mixed", CHUNK), ("prefill", 2 * CHUNK)):
        a = torch.rand((B, t, RG_W), device="cuda") * 0.7 + 0.3
        b = torch.randn((B, t, RG_W), device="cuda")
        h0 = torch.randn((B, RG_W), device="cuda")
        if name == "mixed":
            valid = (torch.arange(t, device="cuda")[None, :]
                     < span[:, None])[..., None]
            a, b = torch.where(valid, a, 1.0), torch.where(valid, b, 0.0)
        y1, h1 = ops.linear_scan(a, b, h0)
        y2, h2 = ops.linear_scan(a, b, h0, impl="ref")
        scale = float(y2.abs().max())
        diff = int((y1 != y2).sum() + (h1 != h2).sum())
        err = max(float((y1 - y2).abs().max()), float((h1 - h2).abs().max()))
        if err > SCAN_RTOL * scale:
            fail(f"linear_scan ({name}) disagrees: {diff} elements differ, "
                 f"max_abs_err {err} against max |y| {scale}")
        n = B * t * RG_W
        bms, by = bound(3 * n * 4 + 2 * B * RG_W * 4, 2 * n,
                        F32_FLOPS_PER_S)
        ms = kernel_device_ms(lambda: kscan.linear_scan(a, b, h0),
                              "::scan<float>")
        wrapper_ms = cuda_ms(lambda: kscan.linear_scan(a, b, h0))
        plain_ms = cuda_ms(lambda: ops.linear_scan(a, b, h0, impl="ref"),
                           iters=5, warmup=1)
        shapes = (f"a/b[{B},{t},{RG_W}] f32, h0[{B},{RG_W}]"
                  + (f", ragged spans {span.tolist()}" if name == "mixed"
                     else ""))
        if name == "mixed":
            row.update(shapes=shapes, max_abs_err=err, elements_differing=diff,
                       ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                       bound_ms=bms, bound_by=by)
        else:
            row.update(prefill_shapes=shapes, prefill_max_abs_err=err,
                       prefill_elements_differing=diff, prefill_ms=ms,
                       prefill_wrapper_ms=wrapper_ms,
                       prefill_plain_ms=plain_ms, prefill_bound_ms=bms)
    return row


# ---------------------------------------------------------------------------
# page_transfer
# ---------------------------------------------------------------------------

# The pool rows disaggregated adoption moves at the workloads' shapes: 513
# pages (the scheduler's 512 and its trash page) of OLMo-1B's bf16 K/V
# rows, the int8 / fp8 pools with their f32 scale rows, and MLA's latent
# rows and scales.
XFER_ROWS = {"olmo_bf16": ((H, PS, D), torch.bfloat16),
             "olmo_int8": ((H, PS, D), torch.int8),
             "olmo_fp8": ((H, PS, D), torch.float8_e4m3fn),
             "olmo_scales": ((H, PS), torch.float32),
             "mla_bf16": ((PS, 640), torch.bfloat16),
             "mla_scales": ((PS,), torch.float32)}
XFER_PAGES, XFER_DST_PAGES = 513, 400


def _bits(t):
    return t.contiguous().view(torch.uint8)


def _xfer_lanes(rng):
    """(one lane, 64 lanes): the 64 hold -1 on both sides, destinations
    past the 400-page destination pool, and repeated destinations."""
    s = rng.integers(0, XFER_PAGES, 64)
    d = rng.integers(0, XFER_DST_PAGES, 64)
    s[[3, 17, 40]] = -1
    d[[5, 22]] = -1
    d[[9, 33]] = XFER_DST_PAGES + np.array([0, 7])
    d[[12, 50, 61]] = d[11]                  # the last live lane wins
    return [(np.array([5]), np.array([7])), (s, d)]


def _xfer_live(s, d) -> tuple[np.ndarray, np.ndarray]:
    """The lanes that write: live on both sides, in range, not superseded
    by a later live lane with the same destination."""
    keep = []
    for i in range(len(s)):
        if s[i] < 0 or d[i] < 0 or d[i] >= XFER_DST_PAGES:
            continue
        if any(d[j] == d[i] and s[j] >= 0 for j in range(i + 1, len(s))):
            continue
        keep.append(i)
    return s[keep], d[keep]


def page_transfer_row(rng) -> dict:
    """``page_transfer`` against its plain version, bitwise, on every pool
    leaf the workloads adopt (one lane, as a pull issues per leaf per
    layer, and 64 lanes), then timed at OLMo-1B's bf16 rows.  ``ms`` is the
    kernel's device time (the profiler's: the wrapper's host work is
    longer than a 64 KB copy); ``library_ms`` is two PyTorch calls,
    ``dst.index_copy_(0, d, src.index_select(0, s))`` on the writing
    lanes.  The bound is 2 x writing lanes x row bytes over the HBM rate."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import page_transfer as kxfer
    lanes = _xfer_lanes(rng)
    checked = []
    for name, (row, dtype) in XFER_ROWS.items():
        gen = torch.Generator(device="cuda").manual_seed(len(name))
        src = torch.randint(0, 256, (XFER_PAGES,) + row, generator=gen,
                            dtype=torch.uint8, device="cuda")
        if dtype.itemsize == 1:
            src = src.view(dtype)
        else:
            src = torch.randn((XFER_PAGES,) + row, generator=gen,
                              device="cuda").to(dtype)
        for s, d in lanes:
            dst = torch.zeros((XFER_DST_PAGES,) + row, dtype=dtype,
                              device="cuda")
            plain = dst.clone()
            si = torch.as_tensor(s, device="cuda")
            di = torch.as_tensor(d, device="cuda")
            ops.page_transfer(src, dst, si, di)
            ref.page_transfer(src, plain, si, di)
            torch.cuda.synchronize()
            if not torch.equal(_bits(dst), _bits(plain)):
                fail(f"page_transfer disagrees with its plain version on "
                     f"{name}, {len(s)} lanes")
            checked.append(f"{name}:{len(s)}")
    row_shape, dtype = XFER_ROWS["olmo_bf16"]
    src = torch.randn((XFER_PAGES,) + row_shape, device="cuda").to(dtype)
    dst = torch.zeros((XFER_DST_PAGES,) + row_shape, dtype=dtype,
                      device="cuda")
    row_bytes = int(np.prod(row_shape)) * dtype.itemsize
    out = dict(name="page_transfer", route="cuda",
               source="src/repro_torch/kernels/csrc/page_transfer.cu",
               replaces="src/repro/kernels/page_transfer.py:96",
               checked_bitwise=checked, max_abs_err=0.0,
               pools_bitwise=True)
    for (s, d), tag in zip(lanes, ("", "64_")):
        si = torch.as_tensor(s, dtype=torch.int32, device="cuda")
        di = torch.as_tensor(d, dtype=torch.int32, device="cuda")
        ls, ld = (torch.as_tensor(x, device="cuda") for x in _xfer_live(s, d))
        live = int(ls.numel())
        bms, by = bound(2 * live * row_bytes, 0)
        out.update({
            f"{tag}shapes": f"pools [{XFER_PAGES}|{XFER_DST_PAGES},{H},{PS},"
                            f"{D}] bf16, {len(s)} lanes ({live} writing)",
            f"{tag}ms": kernel_device_ms(
                lambda: kxfer.page_transfer(src, dst, si, di), "transfer"),
            f"{tag}wrapper_ms": cuda_ms(
                lambda: ops.page_transfer(src, dst, si, di)),
            f"{tag}plain_ms": cuda_ms(
                lambda: ref.page_transfer(src, dst, si, di)),
            f"{tag}library_ms": cuda_ms(
                lambda: dst.index_copy_(0, ld, src.index_select(0, ls))),
            f"{tag}bound_ms": bms, "bound_by": by})
    return out


# ---------------------------------------------------------------------------
# Serving OLMo-1B at full width
# ---------------------------------------------------------------------------

def _agree_share(a, b) -> float:
    """Share of tokens equal before each row's first divergence."""
    a, b = np.asarray(a), np.asarray(b)
    same = 0
    for ra, rb in zip(a, b):
        diff = np.nonzero(ra != rb)[0]
        same += int(diff[0]) if diff.size else len(ra)
    return same / a.size


def _clone(cache):
    return {"layers": [{k: t.clone() for k, t in layer.items()}
                       for layer in cache["layers"]]}


def _compare_logits(lk, lr) -> dict:
    """Kernel-path logits ``lk`` against plain-path ``lr``: the largest
    difference, and whether argmax agrees on every row whose plain top-1 /
    top-2 gap exceeds twice the tolerance (closer rows are near-ties)."""
    top2 = lr.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * LOGITS_ATOL
    same = lk.argmax(-1) == lr.argmax(-1)
    return dict(max_abs_err=float((lk - lr).abs().max()),
                max_abs_logit=float(lr.abs().max()),
                clear_rows=int(clear.sum()), rows=int(lr.shape[0]),
                clear_rows_agree=bool(same[clear].all()))


# The kernel of each route of the first-step check: (paged, kv_quant) ->
# (decode kernel, mixed-step kernel or None).
OLMO_ROUTES = {(False, "off"): ("decode_attention", None),
               (True, "off"): ("paged_decode_attention",
                               "paged_chunk_attention"),
               (True, "int8"): ("paged_decode_attention_quant",
                                "paged_chunk_attention_quant")}
MLA_ROUTES = {(True, "off"): ("paged_mla_decode", "paged_mla_chunk"),
              (True, "int8"): ("paged_mla_decode_quant",
                               "paged_mla_chunk_quant")}
# The recurrent model pages no layer: decode runs decode_attention in its
# local layers, the mixed step linear_scan in its recurrent ones.
RECURRENT_ROUTES = {(False, "off"): ("decode_attention", "linear_scan")}


def _first_step_errors(cfg, params, routes):
    """One kernel-path step against the plain path from the same state,
    for each route: a decode step, then (paged) a mixed step."""
    from repro_torch.models import attention, lm
    rng = np.random.default_rng(1)
    out = {}
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, 128)),
                             device="cuda")
    for (paged, quant), (dec_name, chunk_name) in routes.items():
        cache = lm.init_cache(cfg, B, MAX_LEN, paged=paged, page_size=PS,
                              kv_quant=quant, device="cuda")
        if paged:
            cache = lm.set_block_tables(cache, attention.default_block_tables(
                B, MAX_LEN, PS, "cuda"))
        logits, cache = lm.prefill(params, cfg, prompt, cache)
        tok = logits.argmax(-1)
        pos = torch.full((B,), 128, dtype=torch.int32, device="cuda")
        twin = _clone(cache)
        lk, _ = lm.decode_step(params, cfg, tok, cache, pos, impl="kernel")
        lr, _ = lm.decode_step(params, cfg, tok, twin, pos, impl="ref")
        out[dec_name] = _compare_logits(lk, lr)
        if chunk_name is not None:
            twin = _clone(cache)
            span = torch.as_tensor([64, 33, 1, 1, 0, 64, 17, 2],
                                   dtype=torch.int32, device="cuda")
            toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                (B, CHUNK)), device="cuda")
            lk, _ = lm.mixed_step(params, cfg, toks, cache, pos + 1, span,
                                  impl="kernel")
            lr, _ = lm.mixed_step(params, cfg, toks, twin, pos + 1, span,
                                  impl="ref")
            live = span > 0
            out[chunk_name] = _compare_logits(lk[live], lr[live])
    for name, c in out.items():
        if not (np.isfinite(c["max_abs_err"])
                and c["max_abs_err"] <= LOGITS_ATOL
                and c["clear_rows_agree"]):
            fail(f"first-step logits via {name}: kernel path against the "
                 f"plain path {c}")
    return out


def _mid_run_check(cfg, params, layer_check=False):
    """One step of the scheduler's own run, from the first state that
    holds decode rows and prompt chunks together after pages have grown
    (its tables point unallocated slots at the trash page): the kernel path
    and the plain path step from clones of that cache, and their logits
    must agree as in the first-step check.  ``layer_check`` adds
    ``_state_layer_check`` on the same state."""
    from repro_torch.models import lm
    eng = workload.engine(cfg, params, impl="kernel", device="cuda")
    inner = eng._mixed
    seen = {}

    def probe(params_, cache, toks, start, span, gen=None):
        sp = span.cpu()
        if (not seen and eng.stats["grown_pages"] > 0
                and bool((sp == 1).any()) and bool((sp > 1).any())):
            if layer_check:
                seen.update(_state_layer_check(cfg, params_, toks, start,
                                               span, cache))
            lk, _ = lm.mixed_step(params_, cfg, toks, _clone(cache), start,
                                  span, impl="kernel")
            lr, _ = lm.mixed_step(params_, cfg, toks, _clone(cache), start,
                                  span, impl="ref")
            live = span > 0
            seen.update(_compare_logits(lk[live], lr[live]),
                        step=eng.stats["steps"], spans=sp.tolist(),
                        grown_pages=eng.stats["grown_pages"],
                        trash_entries=int((eng.host_bt
                                           == eng.trash_page).sum()))
        return inner(params_, cache, toks, start, span, gen)

    eng._mixed = probe
    for r in workload.requests(cfg.vocab_size):
        eng.submit(r)
    while not seen and eng.step():
        pass
    if not seen or seen["trash_entries"] == 0:
        fail(f"the scheduler's run reached no mixed state to check: {seen}")
    if not (np.isfinite(seen["max_abs_err"])
            and seen["max_abs_err"] <= LOGITS_ATOL
            and seen["clear_rows_agree"]):
        fail(f"mid-run scheduler step: kernel path against the plain path "
             f"{seen}")
    return seen


def _state_layer_check(cfg, params, toks, start, span, cache) -> dict:
    """One mixed step layer by layer from the same inputs (the kernel
    path's hidden state): each recurrent layer's h and conv state through
    the kernels against the plain path's, counted element by element and
    held to ``SCAN_RTOL`` of the layer's max |h|; each block's output
    where the spans are live."""
    from repro_torch.models import blocks, cache as cache_mod, lm
    from repro_torch.models.blocks import BlockCtx
    c = toks.shape[1]
    x = lm._embed(params, cfg, toks)
    positions = start[:, None] + torch.arange(c, dtype=start.dtype,
                                              device="cuda")[None, :]
    ctx = BlockCtx(positions=positions, mask_full=None, mode="mixed",
                   pos=start, impl="kernel", lengths=span)
    live = (torch.arange(c, device="cuda")[None, :] < span[:, None])
    h_err, h_diff, conv_equal, block_err = [], 0, True, 0.0
    for kind, lp, lc in zip(cache_mod.layer_kinds(cfg), params["layers"],
                            cache["layers"]):
        xk, ak = blocks.block_apply(kind, lp, cfg, x, ctx,
                                    {k: t.clone() for k, t in lc.items()})
        xr, ar = blocks.block_apply(kind, lp, cfg, x,
                                    ctx._replace(impl="ref"),
                                    {k: t.clone() for k, t in lc.items()})
        if kind == "rglru":
            err = float((ak["h"] - ar["h"]).abs().max())
            h_err.append(err)
            h_diff += int((ak["h"] != ar["h"]).sum())
            conv_equal &= torch.equal(ak["conv"], ar["conv"])
            if err > SCAN_RTOL * float(ar["h"].abs().max()):
                fail(f"mid-run step: layer h through the kernels against "
                     f"the plain path: max_abs_err {err}")
        block_err = max(block_err, float(
            (xk.float() - xr.float()).abs()[live].max()))
        x = xk
    if not conv_equal:
        fail("mid-run step: a conv state differs between the paths")
    return dict(h_max_abs_err_per_layer=h_err, h_elements_differing=h_diff,
                conv_bitwise=conv_equal, max_block_err=block_err)


def _serve(cfg, params, impl, **kw):
    """The workload's 16 requests through its scheduler; returns (engine,
    requests, wall s, launch counts of this run)."""
    from repro_torch.kernels import ops
    eng = workload.engine(cfg, params, impl=impl, device="cuda", **kw)
    reqs = workload.requests(cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    return eng, reqs, time.perf_counter() - t, ops.launch_counts()


def _check_answered(cfg, eng, reqs, label) -> None:
    n = workload.N_REQUESTS
    if eng.stats["completed"] != n or any(
            len(r.tokens) != workload.NEW_TOKENS
            or not all(0 <= t < cfg.vocab_size for t in r.tokens)
            for r in reqs):
        fail(f"{label} did not answer all {n} requests: {eng.stats}")


def _serve_report(eng, wall, counts) -> dict:
    st = eng.stats
    return dict(completed=st["completed"], steps=st["steps"],
                gen_tokens=st["gen_tokens"],
                prefill_tokens=st["prefill_tokens"],
                prefill_chunks=st["prefill_chunks"],
                peak_pages=st["peak_pages"], wall_s=wall,
                tokens_per_s=st["gen_tokens"] / wall,
                prompt_and_gen_tokens_per_s=(st["gen_tokens"]
                                             + st["prefill_tokens"]) / wall,
                peak_mem_bytes=torch.cuda.max_memory_allocated(),
                launches=counts)


def _engine_generate(cfg, params, paged, kernel) -> dict:
    """``Engine.generate`` (8 rows of 128 prompt tokens, 16 steps) through
    the kernels and through the plain versions; ``kernel`` (None: the
    route runs none) must have launched in the kernel run."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import Engine
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, 128))
    streams = {}
    for impl in ("kernel", "ref"):
        e = Engine(cfg, params, batch=B, max_len=MAX_LEN, paged=paged,
                   page_size=PS, impl=impl, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t = time.perf_counter()
        streams[impl] = e.generate(prompt, steps=16).cpu().numpy()
        torch.cuda.synchronize()
        if impl == "kernel":
            counts = ops.launch_counts()
            wall = time.perf_counter() - t
            peak = torch.cuda.max_memory_allocated()
            if kernel is not None and counts[kernel] <= 0:
                fail(f"Engine(paged={paged}) never launched {kernel}")
        del e
    return dict(rows=B, prompt_len=128, steps=16, wall_s=wall,
                tokens_per_s=B * 16 / wall, peak_mem_bytes=peak,
                launches=counts,
                greedy_agree_share=_agree_share(streams["kernel"],
                                                streams["ref"]))


def _init_params(cfg):
    from repro_torch.models import lm
    t0 = time.perf_counter()
    params = lm.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


def serving_phase():
    from repro_torch import configs

    cfg = configs.get(workload.ARCH)
    params, init_s = _init_params(cfg)
    results = {}
    eng, reqs, wall, counts = _serve(cfg, params, "kernel")
    if counts["paged_chunk_attention"] <= 0:
        fail("the scheduler never launched paged_chunk_attention")
    _check_answered(cfg, eng, reqs, "scheduler")
    report = _serve_report(eng, wall, counts)
    _, reqs_ref, wall_ref, _ = _serve(cfg, params, "ref")
    results["scheduler"] = dict(
        report, requests=len(reqs), plain_wall_s=wall_ref,
        greedy_agree_share=_agree_share([r.tokens for r in reqs],
                                        [r.tokens for r in reqs_ref]))

    results["scheduler_mid_run_step"] = _mid_run_check(cfg, params)

    # The same workload over int8 page pools (paged_chunk_attention_quant).
    eng, reqs, wall, counts = _serve(cfg, params, "kernel", kv_quant="int8")
    if counts["paged_chunk_attention_quant"] <= 0:
        fail("the int8 scheduler never launched paged_chunk_attention_quant")
    _check_answered(cfg, eng, reqs, "int8 scheduler")
    results["scheduler_int8"] = _serve_report(eng, wall, counts)

    results["engine_dense"] = _engine_generate(cfg, params, False,
                                               "decode_attention")
    results["engine_paged"] = _engine_generate(cfg, params, True,
                                               "paged_decode_attention")
    results["first_step_logits"] = _first_step_errors(cfg, params,
                                                      OLMO_ROUTES)
    results["init_s"] = init_s
    return cfg, params, results


def mla_serving_phase():
    """The MLA workload (``workload.mla_config()``, full width): the
    scheduler on bf16 and on int8 latent pools, ``Engine.generate`` on the
    dense and the paged latent cache, and the first-step kernel-vs-plain
    logits of the two paged routes."""
    cfg = workload.mla_config()
    params, init_s = _init_params(cfg)
    results = {}
    for quant, kernel, name in (("off", "paged_mla_chunk", "scheduler"),
                                ("int8", "paged_mla_chunk_quant",
                                 "scheduler_int8")):
        eng, reqs, wall, counts = _serve(cfg, params, "kernel",
                                         kv_quant=quant)
        if counts[kernel] <= 0:
            fail(f"the MLA {name} never launched {kernel}")
        _check_answered(cfg, eng, reqs, f"MLA {name}")
        results[name] = _serve_report(eng, wall, counts)
    # The dense latent cache runs no kernel (plain matmuls, as in JAX).
    results["engine_dense"] = _engine_generate(cfg, params, False, None)
    results["engine_paged"] = _engine_generate(cfg, params, True,
                                               "paged_mla_decode")
    results["first_step_logits"] = _first_step_errors(cfg, params,
                                                      MLA_ROUTES)
    results["init_s"] = init_s
    return cfg, params, results


def recurrent_serving_phase():
    """The recurrent workload (``workload.RECURRENT_ARCH``, full width):
    the scheduler through the kernels and the plain versions,
    ``Engine.generate`` on the dense and the paged cache, the first-step
    logits of decode and a mixed step, and the mid-run step layer by
    layer."""
    from repro_torch import configs
    cfg = configs.get(workload.RECURRENT_ARCH)
    params, init_s = _init_params(cfg)
    results = {}
    eng, reqs, wall, counts = _serve(cfg, params, "kernel")
    if counts["linear_scan"] <= 0:
        fail("the recurrent scheduler never launched linear_scan")
    _check_answered(cfg, eng, reqs, "recurrent scheduler")
    report = _serve_report(eng, wall, counts)
    _, reqs_ref, wall_ref, _ = _serve(cfg, params, "ref")
    results["scheduler"] = dict(
        report, requests=len(reqs), plain_wall_s=wall_ref,
        greedy_agree_share=_agree_share([r.tokens for r in reqs],
                                        [r.tokens for r in reqs_ref]))
    results["scheduler_mid_run_step"] = _mid_run_check(cfg, params,
                                                       layer_check=True)
    for paged in (False, True):
        res = _engine_generate(cfg, params, paged, "decode_attention")
        if res["launches"]["linear_scan"] <= 0:
            fail(f"Engine(paged={paged}) prefill never launched "
                 f"linear_scan")
        results["engine_paged" if paged else "engine_dense"] = res
    results["first_step_logits"] = _first_step_errors(cfg, params,
                                                      RECURRENT_ROUTES)
    results["init_s"] = init_s
    return cfg, params, results


# ---------------------------------------------------------------------------
# Disaggregated serving at full width
# ---------------------------------------------------------------------------

# The adoption counters, which depend on the schedule alone (eos_id is
# None, so no token value ends a request early): equal across runs that
# differ only in the path (kernels or plain) or the pool dtype.
ADOPTION_COUNTERS = ("adopted_pages", "transferred_pages", "transfer_bytes",
                     "prefill_steps_avoided", "adopt_aborts", "steps",
                     "sync_bytes")


def _page_rows_equal(src_cache, dst_cache, page) -> int:
    """Leaves whose row ``page`` is bitwise equal in both caches; fails on
    any that is not."""
    from repro_torch.models import cache as cache_mod
    src = {path: layer for path, _, layer in
           cache_mod.iter_layers(src_cache)}
    n = 0
    for path, layout, layer in cache_mod.iter_layers(dst_cache):
        for name in cache_mod.pool_leaves(layout):
            if not torch.equal(_bits(layer[name][page]),
                               _bits(src[path][name][page])):
                fail(f"adopted page {page}: leaf {name} of layer "
                     f"{'/'.join(path)} differs from the exporter's")
            n += 1
    return n


def _disagg_run(cfg, params, device, *, xfer_crash=False, **kw) -> dict:
    """One run of the disaggregated workload (``workload.DISAGG``) through
    ``MultiEngineServer``; returns its report, server and requests.  The
    first committed transfer's page is checked bitwise against the
    exporter's in every layer and leaf, and the server's gossip (``sync``)
    is timed on the host."""
    from repro_torch.kernels import ops
    from repro_torch.serving import chaos
    server = workload.disagg_server(cfg, params, device=device, **kw)
    if xfer_crash:
        server.arm_transfer_crash(0)
    reqs = workload.disagg_requests(cfg.vocab_size)
    sync_s = [0.0]
    first = {}
    base_sync, base_pull = server.sync, server._pull_page

    def timed_sync():
        t = time.perf_counter()
        base_sync()
        sync_s[0] += time.perf_counter() - t

    def checked_pull(r, rid, key, lead):
        page = base_pull(r, rid, key, lead)
        if page is not None and not first:
            owner = server.stores[r].lease(page)[0]
            first.update(page=page, exporter=owner, adopter=r,
                         leaves_bitwise=_page_rows_equal(
                             server.engines[owner].cache,
                             server.engines[r].cache, page))
        return page

    server.sync, server._pull_page = timed_sync, checked_pull
    if device != "cpu":
        torch.cuda.synchronize()
    ops.reset_launch_counts()
    walls = workload.run_disagg(server, reqs)
    if device != "cpu":
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    st = server.stats()
    steps = max(1, st["steps"])
    gossip_s = sync_s[0]
    # Quiesce: gossip rounds alone (no engine step) until the replicas'
    # page tables agree; fixed-capacity deltas ship the end-of-run frees
    # over several rounds.
    clock = server.clock
    drained = chaos.drain(server)
    report = dict(st, converged=drained and server.converged(),
                  quiesce_rounds=server.clock - clock,
                  median_step_s=float(np.median(walls)),
                  wall_s=float(np.sum(walls)),
                  gossip_host_s=gossip_s,
                  gossip_host_s_per_step=gossip_s / steps,
                  page_transfer_launches=counts["page_transfer"],
                  first_transfer=first, launches=counts)
    return dict(report=report, server=server, reqs=reqs)


def _stream_gap(cfg, params, prompt, tokens, j) -> float:
    """The plain path's top-1 / top-2 logit gap at generated position
    ``j`` of ``prompt + tokens`` (one forward, no cache)."""
    from repro_torch.models import lm
    seq = torch.as_tensor([list(prompt) + list(tokens[:j])],
                          device=params["embed"]["w"].device)
    logits, _ = lm.forward(params, cfg, seq)
    top2 = logits[0, -1].float().topk(2).values
    return float(top2[0] - top2[1])


def _streams_tie_aware(cfg, params, a, b, label) -> dict:
    """Request by request, the two runs' streams are equal, or their first
    difference falls where the plain path's top-2 gap is at most twice the
    logit tolerance (a near-tie either path may break either way)."""
    differing, gaps = 0, []
    for ra, rb in zip(a, b):
        if ra.tokens == rb.tokens:
            continue
        differing += 1
        j = next(i for i, (x, y) in enumerate(zip(ra.tokens, rb.tokens))
                 if x != y)
        gap = _stream_gap(cfg, params, ra.prompt, ra.tokens, j)
        gaps.append(gap)
        if gap > 2 * LOGITS_ATOL:
            fail(f"disaggregated streams ({label}): request {ra.rid} "
                 f"differs at token {j} where the top-2 gap is {gap}")
    return dict(requests_differing=differing, gaps=gaps)


def disagg_phase(cfg, params, device="cuda") -> dict:
    """The disaggregated workload at full width (``cfg`` / ``params``:
    OLMo-1B's, shared by every engine): adoption on through the kernels,
    adoption off, adoption on through the plain versions, on int8 pools,
    and the exporter crashing in its first transfer (3 replicas)."""
    from repro_torch.serving import chaos
    n = workload.DISAGG_REQUESTS
    runs = {"on": {}, "off": dict(adopt_pages=False),
            "plain": dict(impl="ref"), "int8": dict(kv_quant="int8"),
            "crash": dict(replicas=3, xfer_crash=True)}
    out, done = {}, {}
    for name, kw in runs.items():
        res = _disagg_run(cfg, params, device, **kw)
        rep, server = res["report"], res["server"]
        emit({"disagg_run": name, **{k: v for k, v in rep.items()
                                      if k != "launches"}})
        if name == "crash":
            once, detail = chaos._exactly_once(server)
            balanced, xfer = chaos._xfer_balanced(server)
            rep.update(exactly_once=once, xfer_journal=xfer)
            if not (rep["adopt_aborts"] >= 1 and once and balanced
                    and rep["failed_requests"] == 0
                    and rep["lost_requests"] == 0 and rep["converged"]
                    and len(detail["done_counts"]) == n):
                fail(f"disaggregated crash run: {rep}, {detail}")
        else:
            if rep["completed"] != n or not rep["converged"] or any(
                    len(r.tokens) != workload.DISAGG_NEW for r in res["reqs"]):
                fail(f"disaggregated run {name} did not answer all {n} "
                     f"requests: {rep}")
            if name == "off":
                if rep["transfer_bytes"] != 0 or rep["adopted_pages"] != 0:
                    fail(f"adoption off moved pages: {rep}")
            elif not (rep["adopted_pages"] > 0
                      and rep["prefill_steps_avoided"] > 0
                      and rep["first_transfer"].get("leaves_bitwise")):
                fail(f"disaggregated run {name} adopted nothing: {rep}")
            if name in ("on", "int8") and rep["page_transfer_launches"] <= 0:
                fail(f"disaggregated run {name} never launched "
                     f"page_transfer")
        out[name] = rep
        done[name] = res["reqs"]
        del res, server
        gc.collect()                # the engines' pools, before the next
        if device != "cpu":
            torch.cuda.empty_cache()
    # The plain path moves the same pages, the int8 pools fewer bytes.
    for name, keys in (("plain", ADOPTION_COUNTERS),
                       ("int8", [k for k in ADOPTION_COUNTERS
                                 if k != "transfer_bytes"])):
        a, b = out["on"], out[name]
        if any(a[k] != b[k] for k in keys):
            fail(f"adoption counters differ between the kernel run and "
                 f"{name}: {[(k, a[k], b[k]) for k in keys]}")
    out["streams_on_vs_off"] = _streams_tie_aware(cfg, params, done["on"],
                                                  done["off"], "on/off")
    out["streams_on_vs_plain"] = _streams_tie_aware(cfg, params, done["on"],
                                                    done["plain"],
                                                    "kernel/plain")
    return out


# ---------------------------------------------------------------------------
# The agent trial at full width
# ---------------------------------------------------------------------------

def _mid_trial_check(cfg, params, snap) -> dict:
    """One mixed step from a captured mid-trial state, through the kernels
    and through the plain versions.  Layer by layer from the same inputs
    (the kernel path's hidden state): each layer's pools and scales must
    match bitwise but for the trash page.  End to end (each path its own):
    the logits as ``_compare_logits``."""
    from repro_torch.models import blocks, cache as cache_mod, lm
    from repro_torch.models.blocks import BlockCtx
    toks, start, span, cache, trash = (snap[k] for k in (
        "toks", "start", "span", "cache", "trash"))
    live_rows = span > 0
    lk, _ = lm.mixed_step(params, cfg, toks, _clone(cache), start, span,
                          impl="kernel")
    lr, _ = lm.mixed_step(params, cfg, toks, _clone(cache), start, span,
                          impl="ref")
    out = _compare_logits(lk[live_rows], lr[live_rows])
    c = toks.shape[1]
    x = lm._embed(params, cfg, toks)
    positions = start[:, None] + torch.arange(c, dtype=start.dtype,
                                              device="cuda")[None, :]
    ctx = BlockCtx(positions=positions, mask_full=None, mode="mixed",
                   pos=start, impl="kernel", lengths=span)
    live = (torch.arange(c, device="cuda")[None, :] < span[:, None])
    bitwise, block_err = True, 0.0
    for kind, lp, lc in zip(cache_mod.layer_kinds(cfg), params["layers"],
                            cache["layers"]):
        ak = {k: t.clone() for k, t in lc.items()}
        ar = {k: t.clone() for k, t in lc.items()}
        xk, ak = blocks.block_apply(kind, lp, cfg, x, ctx, ak)
        xr, ar = blocks.block_apply(kind, lp, cfg, x, ctx._replace(impl="ref"),
                                    ar)
        for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
            bitwise &= _pools_equal(ak[name], ar[name], trash)
        block_err = max(block_err, float(
            (xk.float() - xr.float()).abs()[live].max()))
        x = xk
    out.update(pools_bitwise_per_layer=bitwise, max_block_err=block_err,
               spans=span.tolist(), shared_prefix_pages=snap["shared"],
               trash_entries=snap["trash_entries"])
    if not (bitwise and np.isfinite(out["max_abs_err"])
            and out["max_abs_err"] <= LOGITS_ATOL
            and out["clear_rows_agree"]):
        fail(f"mid-trial mixed step: kernel path against the plain path "
             f"{out}")
    return out


class _Captured(Exception):
    """Ends the capture run once its mid-trial state is held."""


def _capture_mid_trial(cfg, params, task) -> dict:
    """Run (a)'s configuration until the first mixed step whose state has
    shared prefix pages, trash-page table slots, and decode rows beside a
    prompt chunk; return a copy of that state.  A run of its own, so the
    timed runs pay nothing for the capture."""
    from repro_torch.agents import orchestrator
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving import scheduler as sched_mod
    mappers, snap = [], {}
    base_mapper = sched_mod.PrefixPageMapper
    base_mixed = engine_mod.make_mixed_step_fn

    class Mapper(base_mapper):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            mappers.append(self)

    def capturing(cfg_, **kw):
        inner = base_mixed(cfg_, **kw)

        def step(params_, cache, toks, start, span, gen=None):
            m = mappers[-1]
            if m.shared_pages > 0 and (m.host_bt == m.trash_page).any():
                sp = span.cpu().numpy()
                if (sp > 1).any() and (sp == 1).any():
                    snap.update(toks=toks.clone(), start=start.clone(),
                                span=span.clone(), cache=_clone(cache),
                                trash=m.trash_page, shared=m.shared_pages,
                                trash_entries=int((m.host_bt
                                                   == m.trash_page).sum()))
                    raise _Captured
            return inner(params_, cache, toks, start, span, gen)
        return step

    sched_mod.PrefixPageMapper = Mapper
    engine_mod.make_mixed_step_fn = capturing
    try:
        orchestrator.run_task(cfg, params, task, device="cuda",
                              **{**TRIAL, "mode": "parallel",
                                 "merge": "allgather"})
    except _Captured:
        pass
    finally:
        sched_mod.PrefixPageMapper = base_mapper
        engine_mod.make_mixed_step_fn = base_mixed
    if not snap:
        fail("trial (a) reached no mid-trial state to check")
    return snap


def _run_trial(cfg, params, task, name, kw) -> dict:
    """One full-width trial run; it must converge within the step valve."""
    from repro_torch.agents import orchestrator
    from repro_torch.kernels import ops
    kw = {**TRIAL, **kw}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    r = orchestrator.run_task(cfg, params, task, device="cuda", **kw)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    res = dict(run=name, model=cfg.name, task=task.name, mode=r.mode,
               n_agents=r.n_agents, kv=r.kv_mode, prefill=r.prefill_mode,
               kv_quant=kw["kv_quant"], merge=r.merge_strategy,
               wall_s=r.wall_s, steps=r.steps, gen_tokens=r.gen_tokens,
               replay_tokens=r.replay_tokens, tokens_per_s=r.tokens_per_s,
               invalidations=r.invalidations,
               claim_collisions=r.claim_collisions,
               sync_rounds=r.sync_rounds, sync_bytes=r.sync_bytes,
               shared_prefix_pages=r.shared_prefix_pages,
               semantic_conflicts=r.semantic_conflicts,
               declared_symbols=r.declared_symbols,
               converged=r.converged, digest=r.digest,
               replicas=r.replicas, disaggregated=r.disaggregated,
               cross_replica_prefix_hits=r.cross_replica_prefix_hits,
               page_sync_bytes=r.page_sync_bytes,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               launches=counts)
    emit({"trial": res})
    if not (r.converged and r.steps <= STEP_VALVE
            and r.gen_tokens >= task.n_todos):
        fail(f"trial ({name}) did not finish: {res}")
    return res


def trial_phase(cfg, params) -> tuple[dict, dict]:
    """The four full-width trial runs, then the mid-trial check from a
    state captured in a run of its own; returns (results, launch counts of
    run (a), the quantized kernels' main path)."""
    from repro_torch.agents.tasks import TASKS
    task = TASKS[TRIAL_TASK]
    runs = {"a": dict(mode="parallel", merge="allgather"),
            "b": dict(mode="parallel", merge="delta"),
            "c": dict(mode="sequential", merge="allgather"),
            "d": dict(mode="parallel", merge="allgather", kv="dense",
                      prefill="replay", kv_quant="off")}
    results = {name: _run_trial(cfg, params, task, name, kw)
               for name, kw in runs.items()}
    a, b = results["a"], results["b"]
    if a["digest"] != b["digest"] or a["gen_tokens"] != b["gen_tokens"]:
        fail(f"trial (a) and (b) differ: digests {a['digest']} / "
             f"{b['digest']}, tokens {a['gen_tokens']} / {b['gen_tokens']}")
    if not b["sync_bytes"] < a["sync_bytes"]:
        fail(f"delta merge shipped {b['sync_bytes']} bytes, allgather "
             f"{a['sync_bytes']}")
    for k in ("paged_chunk_attention_quant", "paged_decode_attention_quant"):
        if a["launches"][k] <= 0:
            fail(f"trial (a) never launched {k}")
    if results["d"]["launches"]["decode_attention"] <= 0:
        fail("trial (d) never launched decode_attention")
    snap = _capture_mid_trial(cfg, params, task)
    results["mid_trial_step"] = _mid_trial_check(cfg, params, snap)
    return results, a["launches"]


def replicated_trial(cfg, params) -> dict:
    """Trial run (g): (a)'s configuration on two page-table metadata
    replicas with disaggregated homes (agent 0 on the prefill domain), the
    replicas gossiping at every coordination sync.  It must converge and
    gossip; its cross-replica prefix hits are reported (each TODO's prompt
    header is mapped by one agent only, so the trial has no prefix for a
    second domain to adopt: JAX's run gives 0 on the CPU too)."""
    from repro_torch.agents.tasks import TASKS
    res = _run_trial(cfg, params, TASKS[TRIAL_TASK], "g",
                     dict(mode="parallel", merge="allgather", replicas=2,
                          disaggregate=True))
    if not (res["replicas"] == 2 and res["disaggregated"]
            and res["page_sync_bytes"] > 0):
        fail(f"trial (g) did not run on replicated page tables: {res}")
    return res


def mla_trial(cfg, params) -> dict:
    """Trial run (e): (a)'s configuration (parallel, paged, chunked, int8
    pools, allgather) on the MLA model; its mixed steps run
    paged_mla_chunk_quant and the outliner's decode steps
    paged_mla_decode_quant."""
    from repro_torch.agents.tasks import TASKS
    res = _run_trial(cfg, params, TASKS[TRIAL_TASK], "e",
                     dict(mode="parallel", merge="allgather"))
    for k in ("paged_mla_chunk_quant", "paged_mla_decode_quant"):
        if res["launches"][k] <= 0:
            fail(f"trial (e) never launched {k}")
    return res


def recurrent_trial(cfg, params) -> dict:
    """Trial run (f): (a)'s configuration (parallel, paged, chunked,
    allgather) on the recurrent model, without int8: no layer of it holds
    a pool.  Its mixed steps run linear_scan in every recurrent layer."""
    from repro_torch.agents.tasks import TASKS
    res = _run_trial(cfg, params, TASKS[TRIAL_TASK], "f",
                     dict(mode="parallel", merge="allgather",
                          kv_quant="off"))
    if res["launches"]["linear_scan"] <= 0:
        fail("trial (f) never launched linear_scan")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is present", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    build.build()
    build_s = time.perf_counter() - t0
    emit({"card": card, "build_s": build_s, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    kernels = kernel_phase()
    emit({"kernel_check": [{k: row[k] for k in ("name", "max_abs_err",
                                                 "ms", "plain_ms")}
                           for row in kernels]})
    cfg, params, serving = serving_phase()
    emit({"serving": serving, "card": card})
    trial, trial_counts = trial_phase(cfg, params)
    emit({"trial_mid_step": trial["mid_trial_step"], "card": card})
    disagg = disagg_phase(cfg, params)
    emit({"disagg_serving": {k: v for k, v in disagg.items()
                             if k.startswith("streams")}, "card": card})
    replicated_trial(cfg, params)
    del params                  # the MLA model takes the card's memory next
    torch.cuda.empty_cache()
    mla_cfg, mla_params, mla_serving = mla_serving_phase()
    emit({"mla_serving": mla_serving, "card": card})
    trial_e = mla_trial(mla_cfg, mla_params)
    del mla_params              # the recurrent model takes the card next
    torch.cuda.empty_cache()
    rec_cfg, rec_params, rec_serving = recurrent_serving_phase()
    emit({"recurrent_serving": rec_serving, "card": card})
    recurrent_trial(rec_cfg, rec_params)
    # Launches: the float kernels and linear_scan on the serving
    # workloads, the quantized kernels on trials (a) and (e),
    # page_transfer on the disaggregated run with adoption on, each path's
    # counts read right after its run.
    launches = {"paged_mla_chunk":
                mla_serving["scheduler"]["launches"]["paged_mla_chunk"],
                "paged_mla_decode":
                mla_serving["engine_paged"]["launches"]["paged_mla_decode"],
                "paged_mla_chunk_quant":
                trial_e["launches"]["paged_mla_chunk_quant"],
                "paged_mla_decode_quant":
                trial_e["launches"]["paged_mla_decode_quant"],
                "paged_chunk_attention":
                serving["scheduler"]["launches"]["paged_chunk_attention"],
                "paged_decode_attention":
                serving["engine_paged"]["launches"]["paged_decode_attention"],
                "decode_attention":
                serving["engine_dense"]["launches"]["decode_attention"],
                "paged_chunk_attention_quant":
                trial_counts["paged_chunk_attention_quant"],
                "paged_decode_attention_quant":
                trial_counts["paged_decode_attention_quant"],
                "linear_scan":
                rec_serving["scheduler"]["launches"]["linear_scan"],
                "page_transfer": disagg["on"]["page_transfer_launches"]}
    for row in kernels:
        row["launches"] = launches[row["name"]]
        if row["name"] == "decode_attention":
            # Its second main path: the recurrent model's dense Engine.
            row["d256_launches"] = (rec_serving["engine_dense"]["launches"]
                                    ["decode_attention"])
        row["kernel_ms"] = row["ms"]
        emit({"kernel": row["name"], **row})
    emit({"card": card})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
