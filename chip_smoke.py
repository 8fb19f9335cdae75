#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and check it end to end.

    python3 chip_smoke.py          # from the repository root

1. builds the three attention kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, started together);
2. holds each kernel against its plain PyTorch version on the card at
   OLMo-1B's shapes (bf16, 16 heads of 128, page size 16, batch 8, contexts
   up to 1024, chunk 64, ragged rows, -1 and trash-page table entries) and
   times kernel, plain version, and the PyTorch library call where one
   computes the same function;
3. serves ``olmo-1b`` at full width with seeded random bf16 weights:
   ``ContinuousBatchingEngine`` answers 16 requests, ``Engine.generate``
   decodes on a dense and on a paged cache; each path runs once through the
   kernels (launch counts must be > 0) and once through the plain versions,
   and the two must agree.

Every line before the last is one JSON object; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit
code is non-zero and that line is never printed.  Without a CUDA card the
script exits with code 2 before doing anything.
"""
from __future__ import annotations

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


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
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
    unspecified when several rows write it)."""
    return torch.equal(a[:trash], b[:trash])


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
    return rows


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


def _first_step_errors(cfg, params):
    """One kernel-path step against the plain path from the same state,
    for each of the three attention routes."""
    from repro_torch.models import attention, lm
    rng = np.random.default_rng(1)
    out = {}
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, 128)),
                             device="cuda")
    for paged in (False, True):
        cache = lm.init_cache(cfg, B, MAX_LEN, paged=paged, page_size=PS,
                              device="cuda")
        if paged:
            cache = lm.set_block_tables(cache, attention.default_block_tables(
                B, MAX_LEN, PS, "cuda"))
        logits, cache = lm.prefill(params, cfg, prompt, cache)
        tok = logits.argmax(-1)
        pos = torch.full((B,), 128, dtype=torch.int32, device="cuda")
        twin = _clone(cache)
        lk, _ = lm.decode_step(params, cfg, tok, cache, pos, impl="kernel")
        lr, _ = lm.decode_step(params, cfg, tok, twin, pos, impl="ref")
        name = "paged_decode_attention" if paged else "decode_attention"
        out[name] = _compare_logits(lk, lr)
        if paged:
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
            out["paged_chunk_attention"] = _compare_logits(lk[live],
                                                           lr[live])
    for name, c in out.items():
        if not (np.isfinite(c["max_abs_err"])
                and c["max_abs_err"] <= LOGITS_ATOL
                and c["clear_rows_agree"]):
            fail(f"first-step logits via {name}: kernel path against the "
                 f"plain path {c}")
    return out


def _mid_run_check(cfg, params):
    """One step of the scheduler's own run, from the first state that
    holds decode rows and prompt chunks together after pages have grown
    (its tables point unallocated slots at the trash page): the kernel path
    and the plain path step from clones of that cache, and their logits
    must agree as in the first-step check."""
    from repro_torch.models import lm
    eng = workload.engine(cfg, params, impl="kernel", device="cuda")
    inner = eng._mixed
    seen = {}

    def probe(params_, cache, toks, start, span, gen=None):
        sp = span.cpu()
        if (not seen and eng.stats["grown_pages"] > 0
                and bool((sp == 1).any()) and bool((sp > 1).any())):
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


def serving_phase():
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serving.engine import Engine

    cfg = configs.get(workload.ARCH)
    t0 = time.perf_counter()
    params = lm.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    results = {}

    def serve(impl):
        eng = workload.engine(cfg, params, impl=impl, device="cuda")
        reqs = workload.requests(cfg.vocab_size)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = ops.launch_counts()
        return eng, reqs, wall, counts

    eng, reqs, wall, counts = serve("kernel")
    peak = torch.cuda.max_memory_allocated()
    if counts["paged_chunk_attention"] <= 0:
        fail("the scheduler never launched paged_chunk_attention")
    n = workload.N_REQUESTS
    if eng.stats["completed"] != n or any(
            len(r.tokens) != workload.NEW_TOKENS
            or not all(0 <= t < cfg.vocab_size for t in r.tokens)
            for r in reqs):
        fail(f"scheduler did not answer all {n} requests: {eng.stats}")
    _, reqs_ref, wall_ref, _ = serve("ref")
    results["scheduler"] = dict(
        requests=len(reqs), completed=eng.stats["completed"],
        steps=eng.stats["steps"], gen_tokens=eng.stats["gen_tokens"],
        prefill_tokens=eng.stats["prefill_tokens"],
        prefill_chunks=eng.stats["prefill_chunks"],
        peak_pages=eng.stats["peak_pages"], wall_s=wall,
        tokens_per_s=eng.stats["gen_tokens"] / wall,
        prompt_and_gen_tokens_per_s=(eng.stats["gen_tokens"]
                                     + eng.stats["prefill_tokens"]) / wall,
        peak_mem_bytes=peak, launches=counts, plain_wall_s=wall_ref,
        greedy_agree_share=_agree_share([r.tokens for r in reqs],
                                        [r.tokens for r in reqs_ref]))

    results["scheduler_mid_run_step"] = _mid_run_check(cfg, params)

    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, 128))
    for paged in (False, True):
        name = "engine_paged" if paged else "engine_dense"
        kernel = "paged_decode_attention" if paged else "decode_attention"
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
                if counts[kernel] <= 0:
                    fail(f"Engine({name}) never launched {kernel}")
            del e
        results[name] = dict(
            rows=B, prompt_len=128, steps=16, wall_s=wall,
            tokens_per_s=B * 16 / wall, peak_mem_bytes=peak,
            launches=counts,
            greedy_agree_share=_agree_share(streams["kernel"],
                                            streams["ref"]))
    results["first_step_logits"] = _first_step_errors(cfg, params)
    results["init_s"] = init_s
    return results


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
    serving = serving_phase()
    launches = {"paged_chunk_attention":
                serving["scheduler"]["launches"]["paged_chunk_attention"],
                "paged_decode_attention":
                serving["engine_paged"]["launches"]["paged_decode_attention"],
                "decode_attention":
                serving["engine_dense"]["launches"]["decode_attention"]}
    for row in kernels:
        row["launches"] = launches[row["name"]]
        row["kernel_ms"] = row["ms"]
        emit({"kernel": row["name"], **row})
    emit({"serving": serving, "card": card})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
