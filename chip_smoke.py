#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and check it end to end.

    python3 chip_smoke.py          # from the repository root

1. builds the fourteen kernels from ``src/repro_torch/kernels/csrc`` (one
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
   256), whisper-tiny's decoder (6 heads of 64 over 256 keys) and the
   agents' sim LLM (4 rows, 4 heads of 16 over 1024 keys), each with
   its split plan and, beside the event times, the profiler's device time
   of the kernels and of SDPA (a plan of several splits must show its
   combine kernel in the trace), ``linear_scan`` at its RG-LRU's (batch
   8, width 2560: the mixed step's 64 steps with ragged identity-padded
   rows, prefill's 128) and ``page_transfer`` bitwise on every pool leaf adoption moves (OLMo's
   bf16 / int8 / fp8 rows and f32 scales, MLA's latent rows and scales;
   one lane and 64 with -1 lanes, out-of-range and repeated destinations,
   pools of 513 and 400 pages; a pulled OLMo-1B page through its 32 bf16
   and 64 int8 leaves in one launch, timed against the one-leaf launches
   and ``torch._foreach_copy_``) and ``flash_attention`` at whisper-tiny's
   encoder shape (q/k/v [8, 6, 1500, 64] bf16, bidirectional; timed against
   SDPA; the trace must show the tensor-core ``flash_fwd_mma``), causal
   GQA with Tq < Tk, and a float32 sliding window, and the
   register-bank kernels ``lww_merge`` and ``delta_apply`` bitwise at
   JAX's sweep shapes and ``bench_merge``'s bank (K 4096, D 128, Dc 256;
   int32 / float32 / bf16 payloads; equal and INT32_MIN keys; duplicate
   targets with equal maximal keys, -1, < -1 and >= K lanes, Dc 0 and 1);
   the eight paged kernels (chunk and decode, MHA and MLA; bf16 and
   quantized pools) also carry their tensor-core walk's profile: the
   profiler's device time of the write, walk and combine, the key-split
   plan (nsplit, split_len, blocks), and a trace that must show
   ``chunk_mma`` / ``mla_mma::walk``, the combine exactly when the plan
   splits, and none of the old walks; the kernel phase draws its CUDA
   inputs from seeded generators, so every run checks the same draws;
   then runs the port's ``bench_merge --quick`` (the replica-sync sweep:
   every delta sync exact, delta < pmax < allgather bytes at rate 0.05;
   its kernel rows launch ``delta_apply``), then the paper's tables
   (``benchmarks.common.run_suite`` on the sim LLM: one run a mode of
   ``tic_tac_toe`` and ``dashboard`` with 4 agents; every trial converges,
   ``decode_attention`` launches; the table 3, 4, 5, 7 and RQ3 rows);
3. serves ``olmo-1b`` at full width with seeded random bf16 weights:
   ``ContinuousBatchingEngine`` answers 16 requests (bf16 pools, then int8
   pools), ``Engine.generate`` decodes on a dense and on a paged cache;
   each path runs once through the kernels (launch counts must be > 0) and
   once through the plain versions, and the two must agree; then the
   same 16 requests with speculative decoding: bf16 pools with the
   ``ngram`` drafter and with an oracle drafter (the non-spec stream),
   int8 pools ``ngram``, each answered with drafts, its verify kernel
   launched and its streams equal to the same pools' non-spec streams but
   at near-ties (the oracle run in fewer steps), with the snapshot's cost;
   and one captured int8 spec step (verify through the kernels against
   the plain path, the rolled-back tail bitwise its pre-verify bytes);
   then the swap tier (``workload.SWAP``: the 16 requests over 96 pages,
   swap off and a host tier of 256 pages): every request answered, no
   page or slot leaked, swap off preempts by recompute and swap on by
   swap in fewer steps, streams equal but at near-ties, and a 32-page
   swap-out / clobber / swap-in round trip bitwise on every bf16 and int8
   leaf, timed;
4. runs the CodeCRDT agent trial (``agents/orchestrator.run_task``) on
   ``olmo-1b`` at full width, 4 agents on ``dashboard``: (a) parallel,
   paged, chunked, int8 pools, allgather merge; (b) as (a) with the delta
   merge; (c) as (a), sequential; (d) parallel on the dense cache with
   token-by-token replay.  Every run must converge; (a) and (b) must give
   the same document and (b) ship fewer bytes; from one mid-trial state of
   (a), captured in a fifth, untimed run, a mixed step runs through the
   kernels and through the plain versions, layer by layer from the same
   inputs (pools bitwise but for the trash page) and end to end (logits);
   trial (h), (a) with ``spec_decode="doc"``, ``spec_k=4``, must converge
   and draft; then disaggregated serving (``workload.DISAGG``: one prefill
   and one decode engine on a replicated page table, sharing OLMo's
   parameters):
   adoption on through the kernels, off, on through the plain versions, on
   int8 pools, and an exporter crash mid-transfer (3 replicas); every run
   answers its 8 requests and converges, the first adopted page equals the
   exporter's bitwise in every layer and leaf, the adoption counters agree
   across paths, streams agree but at near-ties, and the crash run aborts,
   rolls back and completes every request exactly once; then trial run
   (g), (a) on two page-table replicas with disaggregated homes; then the
   fused decode + coordination step (``engine.make_fused_serve_step``,
   phase ``fused_coord``): 8 rows prefilled with 128 tokens, R = 4
   replicas stacked on the card (2 rows each, one doc slot a row), the
   pmax, allgather and delta (capacity 64) merges, ``merge_every`` 1 and
   4, on a dense cache (``decode_attention``) and on pages of 16
   (``paged_decode_attention``), 32 steps each: after every merge all
   replicas' digests equal and the doc is bitwise the fold join of the
   replicas' own appends (the delta frontier that join's), the streams
   equal the plain path's but at near-ties, the decode kernel launched
   and none on the plain path; each step's and each merge's synchronized
   ms and the wire bytes a sync; then a one-rank NCCL group (a file
   store) and a (1, 1) ``DeviceMesh`` through the same step for 8 steps,
   bitwise the stacked route at R = 1, the group destroyed after; then,
   the serving model freed, training: ``olmo-1b`` at full width (seeded
   bf16 weights, one repeated batch of ``DataConfig(vocab_size=50304,
   seq_len=128, batch_size=8)``, ``AdamW(warmup=2)``) through a
   ``Trainer``'s state and ``make_train_step`` on the plain path: a
   warm-up step after which every leaf has changed (its grads finite, the
   same loss and grads with ``remat``), timed steps whose loss falls, the
   step split into forward + backward and the optimizer (events, wall and
   device time) with tokens/s, peak memory, the model-FLOP share and the
   optimizer against its 22-bytes-a-parameter floor, no kernel launched;
   the kernel wrappers refuse a gradient (``forward(impl="kernel")``
   under grad on a reduced whisper-tiny and recurrentgemma-2b raises);
   ``Trainer.save`` of that state restored into a fresh ``Trainer``,
   every leaf bitwise; a reduced olmo-1b and recurrentgemma-2b train step
   with float32 weights on the card against the CPU
   (``train_device_parity``); and JAX's launcher test,
   ``python -m repro_torch.launch.train ... --fail-worker1-at 3``, on the
   card;
5. serves the MLA workload (``workload.mla_config()``: DeepSeek-V2-Lite at
   full width with dense FFNs, seeded random bf16 weights): the scheduler
   on bf16 and int8 latent pools, ``Engine.generate`` on dense and paged
   latent caches, the first-step logits of the paged routes against the
   plain path, the scheduler with ``ngram`` speculation on bf16 and int8
   latent pools; then trial run (e), (a)'s configuration on that model;
   then DeepSeek-V2-Lite at its repo config (``workload.MOE_ARCH``: 27
   ``mla_moe`` layers, 64 routed experts top 6 and 2 shared, 16.2 B
   parameters; the MLA model freed first): the scheduler on bf16 and on
   int8 latent pools (``paged_mla_chunk``, ``_quant``; the MoE calls by
   dispatch), ``Engine.generate`` on the paged latent cache
   (``paged_mla_decode``), a decode and a chunk step through the kernels
   against the plain path layer by layer under the routing rule
   (``ROUTE_STEPS``) and end to end on the rows that route the same, and
   a decode step's device time against the 9.2 ms floor of reading every
   expert's weights; then deepseek-moe-16b (``moe``: MHA and the MoE FFN)
   through the scheduler (``paged_chunk_attention``);
6. serves ``recurrentgemma-2b`` at full width (``workload.RECURRENT_ARCH``,
   seeded random bf16 weights; the MLA model freed first): the scheduler
   through the kernels and through the plain versions, ``Engine.generate``
   on a dense and a paged cache, the first-step logits of decode and of a
   mixed step against the plain path, one mid-run scheduler step layer by
   layer from the same inputs (each recurrent layer's h and conv state
   against the plain path's), the scheduler with ``ngram`` speculation
   (its verify and committed-span replay on ``linear_scan``), then trial
   run (f), (a)'s configuration on that model without int8 (no layer of
   it holds a pool to quantize); then xlstm-125m (``workload
   .XLSTM_ARCH``): the scheduler (no swap pool for a state model),
   ``Engine.generate`` on the dense cache, and a 64-token mixed step held
   to 64 decode steps from the same state (states at the bf16 cache
   tolerance, logits at the chip check's);
7. serves ``whisper-tiny`` at full width (``workload.WHISPER``, seeded
   random bf16 weights and stub frames [8, 1500, 384]): ``Engine.generate``
   through the kernels (its encoder on ``flash_attention``, 4 launches a
   prefill, its decoder on ``decode_attention`` at head_dim 64, 4 a step)
   and through the plain versions; the encoder output, the prefill logits
   and the first decode step's logits of the kernel path against the plain
   path's from the same state;
8. serves ``paligemma-3b`` at full width (``workload.PALIGEMMA``: the
   prefix-LM, 18 layers, 8 heads on 1 KV head of 256, vocabulary 257216;
   seeded random bf16 weights and stub patch embeddings [8, 256, 2048]):
   ``Engine.generate`` on a dense cache (``decode_attention`` at head_dim
   256) and on pages of 16 (``paged_decode_attention`` at head_dim 256)
   through the kernels and through the plain versions, one launch a layer
   a decode step; from the prefill's state the first decode step and one
   after 16 more through the kernels against the plain path (logits), and
   one decode step's device time;
9. prefills ``olmo-1b`` with one prompt of 16,384 tokens
   (``workload.LONG``, past ``lm.CHUNKED_THRESHOLD``: the blockwise
   attention path) and decodes on a dense cache through the kernels and
   the plain versions, the first decode step's logits compared; before
   it, ``attention._sdpa_chunked`` against the masked ``_sdpa`` on one
   layer's q / k / v of 9,216 tokens (bf16 under the bf16 rule, float32
   within 1e-5).

The kernel phase also holds ``paged_decode_attention`` at PaliGemma's
paged shape (head_dim 256, ``d256_`` keys), at granite-34b's group of 48
on one KV head (``g48_``) and starcoder2-15b's group of 12 (``g12_``), and
``decode_attention`` at PaliGemma's dense shape (``pg_``).

Right after the tables, the serving benchmark (``serving_bench_phase``):
``benchmarks.bench_serving.run_bench`` on the card at its full sizes, then
at ``--quick``, whose report goes through ``benchmarks.check_regression``
against the port's CPU baseline
(``benchmarks/baselines/BENCH_serving_quick.json``): every line must pass
but those that follow from the generated tokens (the speculative sweeps'
draft and rollback counts, the int8 identity flags: ``gate_against_cpu``),
which the card's kernels may move by breaking the sim LLM's exact logit
ties otherwise, and which are held to the card's own rules instead; every
analytic counter must equal the baseline's (write and read bytes a step,
resident MB, slot bytes, transfer bytes) and every acceptance flag
of the quick run true (the full run's too, but the two JAX's own bench
computes false at those sizes, ``FULL_SIZE_FALSE``; the int8 greedy-
identity flags, where false, held to the card's tie-aware rule instead,
``INT8_IDENTITY``: every token that differs does so at a bf16 top-2 gap
of at most ``TIE_GAP``, read from the gaps the same report holds); the
launches of the MHA kernels and ``page_transfer`` during the full run are
counted (``decode_attention`` has no caller in
the sweeps: their dense rows run the mixed step's masked path, as JAX's
do); then the three examples run as subprocesses with ``--device
cuda``, each exiting 0.

After the fused coordination step, the sharded phase (``sharded_phase``,
the plain versions under ``impl="ref"``, no kernel launch): on
``DTensor`` weights on a one-rank NCCL (1, 1) mesh, OLMo-1B's prefill,
dense and paged decode and one FSDP train step, xlstm-125m's prefill and
dense decode at full depth, and DeepSeek-V2-Lite's prefill into bf16
latent pages and paged decode with its depth cut to 2 layers, each
bitwise the same calls on plain tensors; the kernel wrappers refuse a
``DTensor``; and the dry run's records of olmo-1b (plain and with the
fused delta step) and xlstm-125m at ``decode_32k`` on the single mesh,
each ``ok`` with collective bytes.

The trials hash (task, TODO) pairs into their prompts, so the script runs
itself again under ``PYTHONHASHSEED=0`` when the variable is not ``0``:
every run's prompts, and so its trial digests, repeat.

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

# The agents' sim LLM (reduced OLMo-1B: d_model 64, 4 heads of 16) at the
# tables' 4 agents.
SIM_B, SIM_H, SIM_D = 4, 4, 16

# The agent trial at full width (phase 4).
TRIAL = dict(n_agents=4, kv="paged", prefill="chunked", page_size=16,
             chunk_size=32, max_len=1024, kv_quant="int8")
TRIAL_TASK = "dashboard"
STEP_VALVE = 20_000


T_START = time.perf_counter()


def emit(obj, stamp: bool = True) -> None:
    """One JSON line; ``stamp`` adds ``at_s``, the seconds since the script
    started, so that the lines of a run give each phase's time (the last
    three lines, fixed by their readers, carry none)."""
    if stamp:
        obj = {**obj, "at_s": time.perf_counter() - T_START}
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


def host_ms(fn, iters: int = 20) -> float:
    """Mean host time of ``fn`` in ms, each call ended by a synchronize,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t) / iters * 1e3


def device_kernel_us(fn, iters: int = 20) -> dict[str, float]:
    """Mean device time in µs a call of ``fn``, by CUDA kernel name (and
    memory operation), over ``iters`` calls after a lead-in call in one
    torch.profiler trace, whose counted launches all have their kernel
    records (``device_trace.kernel_trace``: else taken again)."""
    from repro_torch.launch.device_trace import kernel_trace
    return kernel_trace(fn, iters)


def kernel_device_ms(fn, match: str, iters: int = 20) -> float:
    """Mean device time in ms of the kernels whose name holds ``match``
    (``""``: every kernel of the call) over ``iters`` calls of ``fn``, read
    from torch.profiler: for a kernel shorter than its wrapper's host work,
    events around the calls time the host instead."""
    total_us = sum(us for name, us in device_kernel_us(fn, iters).items()
                   if match in name)
    if total_us <= 0:
        fail(f"the profiler saw no kernel named like {match!r}")
    return total_us / 1e3


def device_kernel_names(fn) -> list[str]:
    """The CUDA kernels one call of ``fn`` ran, by name."""
    names = sorted(device_kernel_us(fn, iters=1))
    if not names:
        fail("the profiler saw no kernel")
    return names


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


def _paged_case(rng, lens, gen):
    """bf16 pools of random rows drawn from ``gen`` and tables from
    ``_tables``."""
    maxp = MAX_LEN // PS
    trash = B * maxp
    kp = torch.randn((trash + 1, H, PS, D), generator=gen,
                     device="cuda").bfloat16()
    vp = torch.randn((trash + 1, H, PS, D), generator=gen,
                     device="cuda").bfloat16()
    bt = torch.as_tensor(_tables(rng, lens, trash), device="cuda")
    return kp, vp, bt, trash


def _pools_equal(a, b, trash) -> bool:
    """Bitwise, every page but the trash page (its contents are
    unspecified when several rows write it); int8 / fp8 pools compare
    their bytes."""
    if a.element_size() == 1:
        a, b = a.view(torch.uint8), b.view(torch.uint8)
    return torch.equal(a[:trash], b[:trash])


def _quant_case(rng, lens, qdtype, gen):
    """[k_pages, k_scales, v_pages, v_scales] (the wrappers' order): pools
    holding quantized random rows and their f32 scales, and tables as
    ``_paged_case``'s."""
    from repro_torch.kernels import ref
    kp, vp, bt, trash = _paged_case(rng, lens, gen)
    kq, ks = ref.quantize_rows(kp, qdtype)
    vq, vs = ref.quantize_rows(vp, qdtype)
    return [kq, ks, vq, vs], bt, trash


def walk_fields(fn, plan, want: str, forbid: tuple, prefix: str = "") -> dict:
    """A tensor-core walk's profile (the chunk and MLA decode kernels):
    ``device_ms`` the profiler's device time of every kernel one call of
    ``fn`` (the kernel module's wrapper) runs, its write, walk and
    combine; the key-split plan; the kernel names.  The trace must show a
    kernel named like ``want``, none like the old walks in ``forbid``, and
    the combine exactly when the plan splits."""
    names = device_kernel_names(fn)
    old = [n for n in names if any(f in n for f in forbid)]
    combined = any("combine" in n for n in names)
    if not any(want in n for n in names) or old or (
            combined != (plan.nsplit > 1)):
        fail(f"the trace of a {want} call shows {names} (plan {plan})")
    return {f"{prefix}device_ms": kernel_device_ms(fn, ""),
            f"{prefix}nsplit": plan.nsplit,
            f"{prefix}split_len": plan.split_len,
            f"{prefix}blocks": plan.blocks,
            f"{prefix}device_kernels": names}


def quant_kernel_rows(rng):
    """The two quantized-pool kernels against their plain versions, int8
    and fp8, at the shapes of the float kernels' checks, on inputs drawn
    from a CUDA generator of seed 12.  The row reports the int8 pools (the
    trial's); fp8 adds its own error and times.  Each row adds its walk's
    profile (``walk_fields``: the tensor-core ``chunk_mma``, never the old
    ``chunk_attend_quant`` or ``attend_kv``; the decode kernel on its
    ``decode_split_plan``)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_chunk_attention_quant as kcq
    from repro_torch.kernels import paged_decode_attention_quant as kdq
    from repro_torch.kernels.decode_attention import sm_count
    scale = D ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(12)
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
            wrapper=kcq.paged_chunk_attention_quant,
            plan=kcq.split_plan(B, H, MAX_LEN, sm_count(0)),
            source="src/repro_torch/kernels/csrc/paged_chunk_attention_quant.cu",
            replaces="src/repro/kernels/paged_chunk_attention.py:389"),
        "paged_decode_attention_quant": dict(
            lens=pos + 1, qshape=(B, H, D), kvshape=(B, H, D),
            idx=(torch.as_tensor(pos, dtype=torch.int32, device="cuda"),),
            op=ops.paged_decode_attention_quant,
            wrapper=kdq.paged_decode_attention_quant,
            plan=kcq.decode_split_plan(B, H, MAX_LEN, sm_count(0)),
            source="src/repro_torch/kernels/csrc/paged_decode_attention_quant.cu",
            replaces="src/repro/kernels/paged_decode_attention.py:355"),
    }
    for name, sp in specs.items():
        row = dict(name=name, route="cuda", source=sp["source"],
                   replaces=sp["replaces"], library_ms=None)
        q = torch.randn(sp["qshape"], generator=gen, device="cuda").bfloat16()
        kn = torch.randn(sp["kvshape"], generator=gen,
                         device="cuda").bfloat16()
        vn = torch.randn(sp["kvshape"], generator=gen,
                         device="cuda").bfloat16()
        for qname, qdtype in (("int8", torch.int8),
                              ("fp8", torch.float8_e4m3fn)):
            pools, bt, trash = _quant_case(rng, sp["lens"], qdtype, gen)
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
            row.update(walk_fields(
                lambda: sp["wrapper"](q, *pools, bt, *sp["idx"], kn, vn,
                                      scale=scale),
                sp["plan"], "chunk_mma",
                ("chunk_attend_quant", "decode_attend", "attend_kv"),
                "" if qname == "int8" else "fp8_"))
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
    trash-page table entries.  q_rope is bf16, as the model passes it (the
    walk reads it in place); a float32 q_rope, the walk's other
    instantiation, is checked too.  Timed through ``ops``, as the model
    calls them.  Every row adds its walk's profile (``walk_fields``: the
    tensor-core ``mla_mma::walk``, never an ``mla::attend``
    instantiation)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_mla_chunk as kmc
    from repro_torch.kernels import paged_mla_chunk_quant as kmq
    from repro_torch.kernels import paged_mla_decode as kmd
    from repro_torch.kernels import paged_mla_decode_quant as kmdq
    from repro_torch.kernels.decode_attention import sm_count
    scale = (128 + MLA_RD) ** -0.5
    lw = MLA_R + MLA_RD
    gen = torch.Generator(device="cuda").manual_seed(13)
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
        q_abs = torch.randn(qs + (MLA_R,), generator=gen, device="cuda")
        q_rope = torch.randn(qs + (MLA_RD,), generator=gen,
                             device="cuda").bfloat16()
        new_shape = (B, CHUNK, MLA_DP) if len(qs) == 3 else (B, MLA_DP)
        new = torch.randn(new_shape, generator=gen, device="cuda").bfloat16()
        new[..., lw:] = 0                       # the model's pad columns
        bt = torch.as_tensor(_tables(rng, lens, B * (MAX_LEN // PS)),
                             device="cuda")
        trash = B * (MAX_LEN // PS)
        row = dict(name=name, route="cuda", source=f"{src}{name}.cu",
                   replaces=f"src/repro/kernels/{tpu}", library_ms=None)
        for qname, qdtype in ((("int8", torch.int8),
                               ("fp8", torch.float8_e4m3fn)) if quant
                              else (("bf16", torch.bfloat16),)):
            pool = torch.randn((trash + 1, PS, MLA_DP), generator=gen,
                               device="cuda")
            pools = (list(ref.quantize_rows(pool, qdtype)) if quant
                     else [pool.bfloat16()])
            twin = [t.clone() for t in pools]
            errs = {}
            # The second pass writes the same rows again: the pools stay
            # the first pass's.
            for qr in (q_rope, q_rope.float()):
                c1 = op(q_abs, qr, *pools, bt, *idx, new, scale=scale)[0]
                c2 = op(q_abs, qr, *twin, bt, *idx, new, scale=scale,
                        impl="ref")[0]
                if len(idx) == 2:               # chunk: defined at j < span
                    live = (torch.arange(CHUNK, device="cuda")[None, :]
                            < idx[1][:, None])[:, None, :, None]
                    c1 = torch.where(live, c1, 0)
                    c2 = torch.where(live, c2, 0)
                err, ok = mla_close(c1, c2)
                bitwise = all(_pools_equal(a, b, trash)
                              for a, b in zip(pools, twin))
                if not (ok and bitwise):
                    fail(f"{name} ({qname}, q_rope {qr.dtype}) disagrees: "
                         f"max_abs_err {err}, pools and scales bitwise "
                         f"{bitwise}")
                errs[qr.dtype] = err
            err, f32_err = errs[torch.bfloat16], errs[torch.float32]
            ms = cuda_ms(lambda: op(q_abs, q_rope, *pools, bt, *idx, new,
                                    scale=scale))
            plain_ms = cuda_ms(lambda: op(q_abs, q_rope, *twin, bt, *idx,
                                          new, scale=scale, impl="ref"))
            wrapper = getattr({"paged_mla_chunk": kmc,
                               "paged_mla_chunk_quant": kmq,
                               "paged_mla_decode": kmd,
                               "paged_mla_decode_quant": kmdq}[name], name)
            row.update(walk_fields(
                lambda: wrapper(q_abs, q_rope, *pools, bt, *idx, new,
                                scale=scale),
                (kmq.split_plan(B, CHUNK, H, MAX_LEN, sm_count(0))
                 if len(qs) == 3 else
                 kmq.decode_split_plan(B, H, MAX_LEN, sm_count(0))),
                "mla_mma::walk", ("mla::attend",),
                "fp8_" if qname == "fp8" else ""))
            if qname == "fp8":
                row.update(fp8_max_abs_err=err, fp8_pools_bitwise=bitwise,
                           fp8_ms=ms, fp8_plain_ms=plain_ms,
                           fp8_f32_q_rope_max_abs_err=f32_err)
            else:
                row.update(shapes=f"q_abs{list(q_abs.shape)} f32 + q_rope "
                                  f"{list(q_rope.shape)} bf16, {qname} pool "
                                  f"[{trash + 1},{PS},{MLA_DP}]"
                                  + (" + f32 scales" if quant else ""),
                           max_abs_err=err, pools_bitwise=bitwise, ms=ms,
                           plain_ms=plain_ms, f32_q_rope_max_abs_err=f32_err)
        # Bytes the function must move: the live r + rd columns of the
        # cached rows that queries attend (one byte plus 4 B of scale per
        # row for a quantized pool), the new Dp-wide rows read at their
        # dtype (bf16) and written once, q read (q_abs float32, q_rope
        # bf16) and ctx written in float32 at the defined queries, and the
        # live table entries.  Operations:
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
                  + nnew * H * (2 * MLA_R * 4 + MLA_RD * 2) + pages * 4
                  + nidx)
        row["bound_ms"], row["bound_by"] = bound(
            nbytes, 2 * pairs * H * (lw + MLA_R))
        rows.append(row)
    return rows


def paged_decode_case(tag, label, hq, hkv, d, ps, max_len, pos, gen,
                      rng) -> dict:
    """``paged_decode_attention`` (bf16 pools) at another main path's shape,
    keys prefixed by ``tag``: 8 rows at positions ``pos`` over tables of
    shuffled live pages (the rest on a trash page), held to the plain
    version under the bf16 rule with the pools bitwise; timed by events
    (kernel and plain) and, with the walk's plan and kernel names, by the
    profiler (``walk_fields``).  The bound counts the rows' cached K/V,
    the new token's K/V read and written, q and out, and the live table
    entries."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_decode_attention as kpdec
    from repro_torch.kernels.decode_attention import sm_count
    from repro_torch.kernels.paged_chunk_attention_quant import (
        decode_split_plan)
    b, maxp = len(pos), max_len // ps
    trash = b * maxp
    perm = rng.permutation(trash)
    tables = np.full((b, maxp), trash, np.int32)
    used = 0
    for i, n in enumerate(pos + 1):
        k = -(-int(n) // ps)
        tables[i, :k] = perm[used:used + k]
        used += k
    bt = torch.as_tensor(tables, device="cuda")

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()
    kp, vp = rand(trash + 1, hkv, ps, d), rand(trash + 1, hkv, ps, d)
    q, kn, vn = rand(b, hq, d), rand(b, hkv, d), rand(b, hkv, d)
    ps_ = torch.as_tensor(pos, dtype=torch.int32, device="cuda")
    scale = d ** -0.5
    kp2, vp2 = kp.clone(), vp.clone()
    o1, _, _ = ops.paged_decode_attention(q, kp, vp, bt, ps_, kn, vn,
                                          scale=scale)
    o2, _, _ = ref.paged_decode_attention(q, kp2, vp2, bt, ps_, kn, vn,
                                          scale=scale)
    err, ok = close(o1, o2)
    bitwise = _pools_equal(kp, kp2, trash) and _pools_equal(vp, vp2, trash)
    if not (ok and bitwise):
        fail(f"paged_decode_attention ({label}) disagrees: max_abs_err "
             f"{err}, pools bitwise {bitwise}")
    share = float(((o1.float() - o2.float()).abs()
                   / (KERNEL_ATOL + KERNEL_RTOL * o2.float().abs())).max())
    pages = int(sum(-(-int(n) // ps) for n in pos + 1))
    nbytes = (2 * int(pos.sum()) * hkv * d * 2 + 2 * 2 * b * hkv * d * 2
              + 2 * q.numel() * 2 + pages * 4 + b * 4)
    bms, by = bound(nbytes, 4 * int((pos + 1).sum()) * hq * d)

    def dec():
        return kpdec.paged_decode_attention(q, kp, vp, bt, ps_, kn, vn,
                                            scale=scale)
    return {f"{tag}shapes": f"q[{b},{hq},{d}] bf16, pools[{trash + 1},"
                            f"{hkv},{ps},{d}], pos {pos.tolist()}",
            f"{tag}max_abs_err": err, f"{tag}rule_share": share,
            f"{tag}pools_bitwise": bitwise, f"{tag}ms": cuda_ms(dec),
            f"{tag}plain_ms": cuda_ms(lambda: ref.paged_decode_attention(
                q, kp2, vp2, bt, ps_, kn, vn, scale=scale)),
            f"{tag}bound_ms": bms, f"{tag}bound_by": by,
            f"{tag}library_ms": None,
            **walk_fields(dec, decode_split_plan(b, hkv, maxp * ps,
                                                 sm_count(0), d),
                          "chunk_mma", ("decode_attend", "attend_kv"),
                          prefix=tag)}


def kernel_phase():
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_chunk_attention as kchunk
    from repro_torch.kernels import paged_decode_attention as kpdec
    from repro_torch.kernels.decode_attention import sm_count
    from repro_torch.kernels.paged_chunk_attention_quant import (
        decode_split_plan)
    rng = np.random.default_rng(0)
    # The MHA rows' CUDA inputs: a generator of their own, seed 11.
    gen = torch.Generator(device="cuda").manual_seed(11)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()
    scale = D ** -0.5
    rows = []

    # paged_chunk_attention: prompt chunks and decode rows in one step.
    start = np.array([0, 100, 300, 447, 700, 900, 959, 64])
    span = np.array([64, 64, 1, 1, 0, 30, 64, 17])
    kp, vp, bt, trash = _paged_case(rng, start + span, gen)
    q, kn, vn = (rand(B, H, CHUNK, D) for _ in range(3))
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

    def walk():
        return kchunk.paged_chunk_attention(q, kp, vp, bt, st, sp, kn, vn,
                                            scale=scale)
    rows.append(dict(
        name="paged_chunk_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_chunk_attention.cu",
        replaces="src/repro/kernels/paged_chunk_attention.py:196",
        shapes=f"q[{B},{H},{CHUNK},{D}] bf16, pools[{trash + 1},{H},{PS},"
               f"{D}], start {start.tolist()}, span {span.tolist()}",
        max_abs_err=err, pools_bitwise=bitwise,
        ms=cuda_ms(walk),
        plain_ms=cuda_ms(lambda: ref.paged_chunk_attention(
            q, kp2, vp2, bt, st, sp, kn, vn, scale=scale)),
        bound_ms=bms, bound_by=by, library_ms=None,
        **walk_fields(walk, kchunk.split_plan(B, H, MAX_LEN, sm_count(0)),
                      "chunk_mma", ("chunk_attend", "attend_kv"))))

    # paged_decode_attention: one token per row at ragged positions.
    pos = np.array([1023, 17, 300, 511, 640, 5, 999, 128])
    kp, vp, bt, trash = _paged_case(rng, pos + 1, gen)
    q, kn, vn = (rand(B, H, D) for _ in range(3))
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

    def dec():
        return kpdec.paged_decode_attention(q, kp, vp, bt, ps_, kn, vn,
                                            scale=scale)
    rows.append(dict(
        name="paged_decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_decode_attention.cu",
        replaces="src/repro/kernels/paged_decode_attention.py:179",
        shapes=f"q[{B},{H},{D}] bf16, pools[{trash + 1},{H},{PS},{D}], "
               f"pos {pos.tolist()}",
        max_abs_err=err, pools_bitwise=bitwise,
        ms=cuda_ms(dec),
        plain_ms=cuda_ms(lambda: ref.paged_decode_attention(
            q, kp2, vp2, bt, ps_, kn, vn, scale=scale)),
        bound_ms=bms, bound_by=by, library_ms=None,
        **walk_fields(dec, decode_split_plan(B, H, MAX_LEN, sm_count(0)),
                      "chunk_mma", ("decode_attend", "attend_kv"))))
    # PaliGemma's paged Engine (workload.PALIGEMMA: head_dim 256, a group
    # of 8 on one KV head, pages of 16 over 512 slots, positions up to
    # 319), and the widest groups of the configs at head_dim 128: granite's
    # 48 on one KV head, starcoder2's 12 (48 heads on 4); their own seeded
    # draws, so the rows above keep theirs.
    xgen = torch.Generator(device="cuda").manual_seed(16)
    xrng = np.random.default_rng(16)
    rows[-1].update(paged_decode_case(
        "d256_", "PaliGemma, head_dim 256", 8, 1, 256,
        workload.PALIGEMMA["page_size"], workload.PALIGEMMA["max_len"],
        np.array([319, 0, 31, 255, 256, 288, 300, 100]), xgen, xrng))
    rows[-1].update(paged_decode_case(
        "g48_", "granite-34b, group 48", 48, 1, D, PS, MAX_LEN, pos, xgen,
        xrng))
    rows[-1].update(paged_decode_case(
        "g12_", "starcoder2-15b, group 12", 48, 4, D, PS, MAX_LEN, pos,
        xgen, xrng))

    # decode_attention: dense [B, H, 1024, D] cache, ragged kv_len.
    kv_len = np.array([1024, 18, 301, 512, 641, 6, 1000, 129])
    row = dict(name="decode_attention", route="cuda",
               source="src/repro_torch/kernels/csrc/decode_attention.cu",
               replaces="src/repro/kernels/decode_attention.py:95",
               pools_bitwise=None)
    dgen = torch.Generator(device="cuda").manual_seed(14)
    row.update(decode_attention_case(
        "", "OLMo-1B", *_decode_inputs(B, H, H, MAX_LEN, D, dgen), kv_len))
    row.update(decode_attention_case(
        "d256_", "head_dim 256, MQA", *_decode_inputs(
            B, RG_HQ, RG_HKV, MAX_LEN, RG_D, dgen), kv_len))
    if row["d256_nsplit"] < 2:
        fail(f"decode_attention at RecurrentGemma's shape ran one split: "
             f"{row['d256_device_kernels']}")
    # whisper-tiny's decoder self-attention (workload.WHISPER): 6 heads of
    # 64 over its max_len 256 cache, ragged kv_len up to 256.
    row.update(decode_attention_case(
        "d64_", "head_dim 64, whisper decoder", *_decode_inputs(
            B, WH_H, WH_H, WH_MAX_LEN, WH_D, dgen),
        np.array([256, 33, 1, 200, 129, 84, 255, 17])))
    # The agents' sim LLM (the tables' trials): 4 rows, 4 heads of 16 over
    # its max_len 1024 dense cache.
    row.update(decode_attention_case(
        "sim_", "head_dim 16, sim LLM", *_decode_inputs(
            SIM_B, SIM_H, SIM_H, MAX_LEN, SIM_D, dgen),
        np.array([1024, 37, 300, 641])))
    # PaliGemma's dense Engine: 8 heads on 1 KV head of 256 over its
    # max_len 512 cache, kv_len up to 320.
    row.update(decode_attention_case(
        "pg_", "head_dim 256, PaliGemma", *_decode_inputs(
            B, 8, 1, workload.PALIGEMMA["max_len"], 256, dgen),
        np.array([320, 1, 32, 256, 257, 289, 301, 101])))
    rows.append(row)
    rows += quant_kernel_rows(rng)
    rows += mla_kernel_rows(rng)
    rows.append(linear_scan_row(rng))
    rows.append(page_transfer_row(rng))
    rows.append(flash_attention_row())
    rows.append(lww_merge_row(rng))
    rows.append(delta_apply_row(rng))
    return rows


# whisper-tiny's encoder attention (workload.WHISPER): 6 heads of 64 over
# its 1500 frames, batch 8, bidirectional.
WH_B, WH_H, WH_T, WH_D = 8, 6, 1500, 64
WH_MAX_LEN = workload.WHISPER["max_len"]     # the decoder's cache
# Kernel against plain version, float32 outputs: the same math summed in
# another order.
KERNEL_TOL_F32 = 1e-5


def flash_attention_row() -> dict:
    """``flash_attention`` at the whisper encoder's shape (held to the
    plain version under the bf16 rule, timed against it and SDPA by events,
    and by the profiler's device time: ``device_ms`` the kernel's,
    ``library_device_ms`` every kernel of the SDPA call; the trace must show
    the tensor-core kernel ``flash_fwd_mma``), and two more cases held the
    same way: causal GQA with Tq < Tk (bf16) and a float32 sliding window
    (1e-5).  The bound: q, k, v read and out written once against
    4·B·Hq·Tq·Tk·D FLOPs at the bf16 tensor-core peak; here the operations
    win."""
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda").manual_seed(5)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    extra = {}
    for name, (b, hq, hkv, tq, tk, d, causal, window, dtype) in {
            "gqa_causal": (8, 6, 2, 500, 1500, 64, True, None,
                           torch.bfloat16),
            "window_f32": (4, 6, 6, 1024, 1024, 64, True, 256,
                           torch.float32)}.items():
        q, k, v = (rand(b, h, t, d, dtype=dtype)
                   for h, t in ((hq, tq), (hkv, tk), (hkv, tk)))
        o1 = ops.flash_attention(q, k, v, causal=causal, window=window)
        o2 = ref.flash_attention(q, k, v, causal=causal, window=window)
        if dtype == torch.float32:
            err = float((o1 - o2).abs().max())
            ok = bool(((o1 - o2).abs()
                       <= KERNEL_TOL_F32 * (1 + o2.abs())).all())
        else:
            err, ok = close(o1, o2)
        if not ok:
            fail(f"flash_attention ({name}) disagrees: max_abs_err {err}")
        extra[f"{name}_shapes"] = (f"q[{b},{hq},{tq},{d}] k/v[{b},{hkv},{tk},"
                                   f"{d}] {str(dtype)[6:]}, causal {causal},"
                                   f" window {window}")
        extra[f"{name}_max_abs_err"] = err

    q, k, v = (rand(WH_B, WH_H, WH_T, WH_D) for _ in range(3))
    scale = WH_D ** -0.5
    o1 = ops.flash_attention(q, k, v, causal=False)
    o2 = ref.flash_attention(q, k, v, causal=False)
    err, ok = close(o1, o2)
    if not ok:
        fail(f"flash_attention (whisper encoder) disagrees: max_abs_err "
             f"{err}")
    lib = torch.nn.functional.scaled_dot_product_attention
    lib_err, lib_ok = close(lib(q, k, v, scale=scale), o2)
    if not lib_ok:
        fail(f"the SDPA yardstick computes another function: {lib_err}")
    bms, by = bound(4 * q.numel() * 2,
                    4 * WH_B * WH_H * WH_T * WH_T * WH_D)
    names = device_kernel_names(lambda: kflash.flash_attention(
        q, k, v, causal=False, scale=scale, window=None))
    ran = [n for n in names if "flash_fwd" in n]
    if not ran or not all("flash_fwd_mma" in n for n in ran):
        fail(f"flash_attention (bf16) did not run the tensor-core kernel: "
             f"{names}")
    return dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:127",
        shapes=f"q/k/v[{WH_B},{WH_H},{WH_T},{WH_D}] bf16, bidirectional",
        max_abs_err=err, pools_bitwise=None,
        ms=cuda_ms(lambda: kflash.flash_attention(
            q, k, v, causal=False, scale=scale, window=None)),
        plain_ms=cuda_ms(lambda: ref.flash_attention(q, k, v, causal=False,
                                                     scale=scale)),
        device_ms=kernel_device_ms(lambda: kflash.flash_attention(
            q, k, v, causal=False, scale=scale, window=None), "flash_fwd"),
        bound_ms=bms, bound_by=by, device_kernels=ran,
        library_ms=cuda_ms(lambda: lib(q, k, v, scale=scale)),
        library_device_ms=kernel_device_ms(lambda: lib(q, k, v, scale=scale),
                                           ""), **extra)


# RecurrentGemma-2B's shapes (workload.RECURRENT_ARCH): local attention of
# 10 query heads on 1 KV head of 256 over a dense cache of max_len keys;
# the RG-LRU of width 2560.
RG_HQ, RG_HKV, RG_D, RG_W = 10, 1, 256, 2560


def _decode_inputs(b, hq, hkv, s, d, gen):
    """q [b, hq, d] and k, v [b, hkv, s, d], bf16, random from ``gen``."""
    return tuple(torch.randn(shape, generator=gen, device="cuda").bfloat16()
                 for shape in ((b, hq, d), (b, hkv, s, d), (b, hkv, s, d)))


def decode_attention_case(tag, label, q, k, v, kv_len) -> dict:
    """``decode_attention`` at one main path's shape, keys prefixed by
    ``tag``: held to the plain version under the bf16 rule; timed by
    events (``ms``, ``plain_ms``, SDPA's ``library_ms``) and by the
    profiler's device time (``device_ms``: the split walk and the combine,
    ``dense_attend_*``; ``library_device_ms``: every kernel of the SDPA
    call); the split plan (``nsplit``, ``split_len``, ``blocks``) beside
    them.  A plan of more than one split must show its combine kernel in
    the trace.  The bound counts the valid prefixes' K/V, q and out."""
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import ops, ref
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    scale = d ** -0.5
    kl = torch.as_tensor(kv_len, dtype=torch.int32, device="cuda")
    o1 = ops.decode_attention(q, k, v, kl, scale=scale)
    o2 = ref.decode_attention(q, k, v, kl, scale=scale)
    err, ok = close(o1, o2)
    if not ok:
        fail(f"decode_attention ({label}) disagrees: max_abs_err {err}")
    mask = (torch.arange(s, device="cuda")[None, :]
            < kl[:, None])[:, None, None, :]
    lib = torch.nn.functional.scaled_dot_product_attention
    kx, vx = (t.expand(-1, hq, -1, -1) if hkv != hq else t for t in (k, v))
    lib_err, lib_ok = close(lib(q[:, :, None], kx, vx, attn_mask=mask,
                                scale=scale)[:, :, 0], o2)
    if not lib_ok:
        fail(f"the SDPA yardstick computes another function: {lib_err}")
    plan = kdec.split_plan(b, hq, s, d, kdec.sm_count(0))
    names = device_kernel_names(
        lambda: kdec.decode_attention(q, k, v, kl, scale=scale))
    ran = [n for n in names if "dense_attend" in n]
    if not any("dense_attend_split" in n for n in ran) or (
            plan.nsplit > 1) != any("dense_attend_combine" in n for n in ran):
        fail(f"decode_attention ({label}): plan {plan} ran {names}")
    keys = int(kv_len.sum())
    bms, by = bound(2 * keys * hkv * d * 2 + 2 * q.numel() * 2 + b * 4,
                    4 * keys * hq * d)
    return {
        f"{tag}shapes": f"q[{b},{hq},{d}] bf16, k/v[{b},{hkv},{s},{d}], "
                        f"kv_len {kv_len.tolist()}",
        f"{tag}max_abs_err": err,
        f"{tag}ms": cuda_ms(lambda: kdec.decode_attention(q, k, v, kl,
                                                          scale=scale)),
        f"{tag}device_ms": kernel_device_ms(
            lambda: kdec.decode_attention(q, k, v, kl, scale=scale),
            "dense_attend"),
        f"{tag}plain_ms": cuda_ms(lambda: ref.decode_attention(
            q, k, v, kl, scale=scale)),
        f"{tag}bound_ms": bms, f"{tag}bound_by": by,
        f"{tag}library_ms": cuda_ms(lambda: lib(
            q[:, :, None], kx, vx, attn_mask=mask, scale=scale)),
        f"{tag}library_device_ms": kernel_device_ms(lambda: lib(
            q[:, :, None], kx, vx, attn_mask=mask, scale=scale), ""),
        f"{tag}device_kernels": ran,
        f"{tag}nsplit": plan.nsplit, f"{tag}split_len": plan.split_len,
        f"{tag}blocks": plan.blocks}


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
    gen = torch.Generator(device="cuda").manual_seed(15)
    for name, t in (("mixed", CHUNK), ("prefill", 2 * CHUNK)):
        a = torch.rand((B, t, RG_W), generator=gen, device="cuda") * 0.7 + 0.3
        b = torch.randn((B, t, RG_W), generator=gen, device="cuda")
        h0 = torch.randn((B, RG_W), generator=gen, device="cuda")
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


# A pulled OLMo-1B page: every pool leaf of its 16 paged layers, K and V
# (bf16: 32 leaves of 64 KB), and the int8 pools' f32 scales beside them
# (64 leaves: 32 of 32 KB, 32 of 1 KB).
PULLED_PAGES = {"pulled_bf16": ["olmo_bf16"] * 32,
                "pulled_int8": ["olmo_int8", "olmo_scales"] * 32}


def pulled_page_fields(tag: str, leaves: list) -> dict:
    """One pulled page (one lane) through every leaf in one
    ``page_transfer`` launch, as ``copy_pages_across`` issues it: every
    destination pool bitwise against the plain version leaf by leaf, the
    launch count, the kernel's device time, the same leaves as one-leaf
    launches (the sum of their device times), ``torch._foreach_copy_``
    over the one-row views (one PyTorch call moving the same bytes, ids
    known on the host: the yardstick) and the bound (every leaf's row read
    and written once)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import page_transfer as kxfer
    gen = torch.Generator(device="cuda").manual_seed(len(tag))
    pairs = []
    for name in leaves:
        row, dtype = XFER_ROWS[name]
        shapes = [(pages,) + row for pages in (XFER_PAGES, XFER_DST_PAGES)]
        if dtype.itemsize == 1:
            pairs.append(tuple(torch.randint(
                0, 256, shape, generator=gen, dtype=torch.uint8,
                device="cuda").view(dtype) for shape in shapes))
        else:
            pairs.append(tuple(torch.randn(shape, generator=gen,
                                           device="cuda").to(dtype)
                               for shape in shapes))
    si = torch.tensor([5], dtype=torch.int32, device="cuda")
    di = torch.tensor([7], dtype=torch.int32, device="cuda")
    plains = [d.clone() for _, d in pairs]
    for (s, _), plain in zip(pairs, plains):
        ref.page_transfer(s, plain, si, di)
    before = kxfer.launches
    ops.page_transfer_leaves(pairs, si, di)
    torch.cuda.synchronize()
    if kxfer.launches - before != 1:
        fail(f"{tag}: {len(pairs)} leaves took {kxfer.launches - before} "
             f"launches, not one")
    if not all(torch.equal(_bits(d), _bits(p))
               for (_, d), p in zip(pairs, plains)):
        fail(f"{tag}: page_transfer_leaves disagrees with the plain version")
    del plains
    page_bytes = sum(d[0].numel() * d.element_size() for _, d in pairs)
    s_rows = [s[5:6] for s, _ in pairs]
    d_rows = [d[7:8] for _, d in pairs]
    bms, _ = bound(2 * page_bytes, 0)
    return {f"{tag}_leaves": len(pairs), f"{tag}_bytes": page_bytes,
            f"{tag}_ms": kernel_device_ms(
                lambda: kxfer.page_transfer_leaves(pairs, si, di),
                "transfer"),
            f"{tag}_one_leaf_sum_ms": kernel_device_ms(
                lambda: [kxfer.page_transfer_leaves([(s, d)], si, di)
                         for s, d in pairs], "transfer"),
            f"{tag}_foreach_copy_ms": kernel_device_ms(
                lambda: torch._foreach_copy_(d_rows, s_rows), ""),
            f"{tag}_bound_ms": bms}


def page_transfer_row(rng) -> dict:
    """``page_transfer`` against its plain version, bitwise, on every pool
    leaf the workloads adopt (one lane and 64 lanes), a pulled OLMo-1B
    page through its 32 bf16 and 64 int8 leaves in one launch
    (``pulled_page_fields``), then timed at OLMo-1B's bf16 rows.  ``ms``
    is the kernel's device time (the profiler's: the wrapper's host work is
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
    out = dict(name="page_transfer", route="cuda",
               source="src/repro_torch/kernels/csrc/page_transfer.cu",
               replaces="src/repro/kernels/page_transfer.py:96",
               checked_bitwise=checked, max_abs_err=0.0,
               pools_bitwise=True)
    for tag, leaves in PULLED_PAGES.items():
        out.update(pulled_page_fields(tag, leaves))
    row_shape, dtype = XFER_ROWS["olmo_bf16"]
    src = torch.randn((XFER_PAGES,) + row_shape, device="cuda").to(dtype)
    dst = torch.zeros((XFER_DST_PAGES,) + row_shape, dtype=dtype,
                      device="cuda")
    row_bytes = int(np.prod(row_shape)) * dtype.itemsize
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
                lambda: kxfer.page_transfer_leaves([(src, dst)], si, di),
                "transfer"),
            f"{tag}wrapper_ms": cuda_ms(
                lambda: ops.page_transfer(src, dst, si, di)),
            f"{tag}plain_ms": cuda_ms(
                lambda: ref.page_transfer(src, dst, si, di)),
            f"{tag}library_ms": cuda_ms(
                lambda: dst.index_copy_(0, ld, src.index_select(0, ls))),
            f"{tag}bound_ms": bms, "bound_by": by})
    return out


# ---------------------------------------------------------------------------
# Register banks: lww_merge and delta_apply (replica sync)
# ---------------------------------------------------------------------------

# JAX's sweep shapes (tests/test_kernels.py:26 and :63: K, D, Dc) and the
# payload dtypes the banks are held at; bench_merge's bank comes on top.
BANK_SWEEP = [(1, 1, 1), (7, 3, 4), (128, 8, 16), (1000, 17, 33),
              (4096, 4, 256)]
BANK_DTYPES = (torch.int32, torch.float32, torch.bfloat16)
INT32_MIN = np.iinfo(np.int32).min


def _bank_pay(rng, shape, dtype):
    if dtype == torch.int32:
        x = rng.integers(-99, 99, shape)
    else:
        x = rng.normal(size=shape)
    return torch.as_tensor(x, device="cuda").to(dtype)


def _i32(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.int32, device="cuda")


def _bank_equal(got, want) -> bool:
    return (torch.equal(got[0], want[0])
            and torch.equal(_bits(got[1]), _bits(want[1])))


def lww_merge_row(rng) -> dict:
    """``lww_merge`` against its plain version, bitwise, at JAX's sweep
    shapes and bench_merge's bank [4096, 128], int32 / float32 / bf16
    payloads, random keys, equal keys (a wins) and INT32_MIN keys; timed
    at [4096, 128] int32.  ``ms`` is the kernel's device time (the
    profiler's).  No path of either package calls this kernel (JAX's
    ``core/lww.py`` keeps the jnp join): its launches stay 0 outside this
    phase.  The bound counts three key vectors and one winner row read
    and written a register."""
    from repro_torch.kernels import lww_merge as klww
    from repro_torch.kernels import ops, ref
    checked = 0
    for k, d, _ in BANK_SWEEP + [(4096, 128, 256)]:
        for dtype in BANK_DTYPES:
            for keys in ("random", "ties", "int32_min"):
                ka = rng.integers(0, 10_000, k)
                kb = rng.integers(0, 10_000, k)
                if keys == "ties":
                    kb[::2] = ka[::2]
                elif keys == "int32_min":
                    ka[::3] = INT32_MIN
                    kb[::2] = INT32_MIN
                ka, kb = _i32(ka), _i32(kb)
                pa, pb = (_bank_pay(rng, (k, d), dtype) for _ in range(2))
                got = ops.lww_merge(ka, pa, kb, pb)
                want = ref.lww_merge(ka, pa, kb, pb)
                torch.cuda.synchronize()
                if not _bank_equal(got, want):
                    fail(f"lww_merge disagrees with its plain version at "
                         f"K {k}, D {d}, {dtype}, {keys} keys")
                checked += 1
    k, d = 4096, 128
    ka, kb = _i32(rng.integers(0, 10_000, k)), _i32(rng.integers(0, 10_000, k))
    pa, pb = (_bank_pay(rng, (k, d), torch.int32) for _ in range(2))
    bms, by = bound(k * (3 * 4 + 2 * d * 4), k, F32_FLOPS_PER_S)
    return dict(
        name="lww_merge", route="cuda",
        source="src/repro_torch/kernels/csrc/lww_merge.cu",
        replaces="src/repro/kernels/lww_merge.py:40",
        shapes=f"key i32[{k}] x2, pay[{k},{d}] i32 x2",
        checked_bitwise=f"{checked} cases: K,D {[c[:2] for c in BANK_SWEEP]}"
                        f" and ({k}, {d}) x int32/float32/bf16 x random/"
                        f"equal/INT32_MIN keys",
        max_abs_err=0.0, pools_bitwise=True,
        ms=kernel_device_ms(lambda: klww.lww_merge(ka, pa, kb, pb),
                            "lww_merge_rows"),
        wrapper_ms=cuda_ms(lambda: ops.lww_merge(ka, pa, kb, pb)),
        plain_ms=cuda_ms(lambda: ref.lww_merge(ka, pa, kb, pb)),
        bound_ms=bms, bound_by=by, library_ms=None,
        launches_note="kernel phase only: no caller in either package")


def _delta_cases(rng, k, d, dc, dtype):
    """(d_idx, d_key, d_pay) lane sets at one bank shape: unique targets
    with ~25 % empty lanes (JAX's sweep); duplicates with equal maximal
    keys, keys equal to the bank's, -1, < -1 and >= K lanes; Dc 0 and 1."""
    idx = rng.permutation(k)[:dc]
    idx[rng.random(dc) < 0.25] = -1
    cases = [(idx, rng.integers(0, 20_000, dc), dc)]
    n = max(dc, 8)
    dup = rng.integers(-3, k + 3, n)
    dup[:4] = k // 2
    dup[4], dup[5] = -7, 2 ** 31 - 1
    dkey = rng.integers(0, 10_000, n)
    dkey[:4] = [20_000, 30_000, 30_000, 25_000]
    dkey[6] = INT32_MIN
    cases.append((dup, dkey, n))
    cases += [(rng.integers(0, k, m), rng.integers(0, 20_000, m), m)
              for m in (0, 1)]
    return [(_i32(i), _i32(kk), _bank_pay(rng, (m, d), dtype))
            for i, kk, m in cases]


def delta_apply_row(rng) -> dict:
    """``delta_apply`` against its plain version, bitwise, at JAX's sweep
    shapes and bench_merge's (K 4096, D 128, Dc 256), int32 / float32 /
    bf16 payloads, on each lane set of ``_delta_cases``; timed on
    bench_merge's own inputs (``kernel_inputs``).  ``ms`` is the kernel's
    device time (the profiler's).  The bound counts each register's key
    and one source row (the bank's or the winning lane's) read and written
    once, and every lane's (idx, key) read once.  ``copy_floor_ms`` is the
    device time of ``key.clone()`` and ``pay.clone()``: the bank's bytes
    copied once, a yardstick (no one PyTorch call computes the
    function)."""
    from repro_torch.benchmarks import bench_merge
    from repro_torch.kernels import delta_apply as kdelta
    from repro_torch.kernels import ops, ref
    checked = 0
    for k, d, dc in BANK_SWEEP + [bench_merge.KERNEL_SHAPE]:
        for dtype in BANK_DTYPES:
            key = _i32(rng.integers(0, 10_000, k))
            pay = _bank_pay(rng, (k, d), dtype)
            for di, dk, dp in _delta_cases(rng, k, d, min(dc, k), dtype):
                got = ops.delta_apply(key, pay, di, dk, dp)
                want = ref.delta_apply(key, pay, di, dk, dp)
                torch.cuda.synchronize()
                if not _bank_equal(got, want):
                    fail(f"delta_apply disagrees with its plain version at "
                         f"K {k}, D {d}, Dc {di.numel()}, {dtype}")
                checked += 1
    key, pay, idx, dkey, dpay = bench_merge.kernel_inputs("cuda")
    k, d, dc = bench_merge.KERNEL_SHAPE
    # Each output row is copied from one source row, the bank's or its
    # winning lane's: K keys and rows read and written, and every lane's
    # (idx, key) read once.
    bms, by = bound(2 * k * (4 + d * 4) + 8 * dc, k + dc, F32_FLOPS_PER_S)
    return dict(
        name="delta_apply", route="cuda",
        source="src/repro_torch/kernels/csrc/delta_apply.cu",
        replaces="src/repro/kernels/delta_apply.py:72",
        shapes=f"key i32[{k}], pay[{k},{d}] i32, lanes i32[{dc}] + "
               f"pay[{dc},{d}] (bench_merge.kernel_rows)",
        checked_bitwise=f"{checked} cases: K,D,Dc {BANK_SWEEP} and "
                        f"{bench_merge.KERNEL_SHAPE} x int32/float32/bf16 x "
                        f"unique+empty / duplicates+out-of-range / Dc 0 / "
                        f"Dc 1",
        max_abs_err=0.0, pools_bitwise=True,
        ms=kernel_device_ms(
            lambda: kdelta.delta_apply(key, pay, idx, dkey, dpay),
            "delta_apply_rows"),
        wrapper_ms=cuda_ms(lambda: ops.delta_apply(key, pay, idx, dkey,
                                                   dpay)),
        plain_ms=cuda_ms(lambda: ref.delta_apply(key, pay, idx, dkey, dpay)),
        copy_floor_ms=kernel_device_ms(lambda: (key.clone(), pay.clone()),
                                       ""),
        bound_ms=bms, bound_by=by, library_ms=None)


def bench_merge_phase() -> dict:
    """The port's ``bench_merge --quick`` on the card, through its entry
    point: every cell's delta sync exact, delta < pmax < allgather bytes
    at rate 0.05 (JAX's acceptance, at R 4; at R 2 pmax = allgather), and the kernel rows through ``delta_apply`` (launches
    counted from 0 just before the run).  The sweep's states are 16 KB:
    its rows time eager host work, not the card."""
    import contextlib
    import io
    from repro_torch.benchmarks import bench_merge
    from repro_torch.kernels import ops
    out = io.StringIO()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        bench_merge.main(["--quick"])
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    lines = out.getvalue().splitlines()
    if lines[0] != "name,us_per_call,derived":
        fail(f"bench_merge printed no CSV header: {lines[:1]}")
    rows = {}
    for line in lines[1:]:
        name, us, derived = line.split(",")
        rows[name] = dict(us=float(us), **dict(
            kv.split("=") for kv in derived.split(";")))
    merges = {n: r for n, r in rows.items() if n.startswith("merge/")}
    if len(merges) != 12 or any(r["exact"] != "1" for r in merges.values()):
        fail(f"bench_merge: a delta sync was not exact: {merges}")
    for r in (2, 4):
        cell = f"R{r}_S256_rate0.05"
        d, p, a = (int(rows[f"merge/{s}/{cell}"]["bytes"])
                   for s in ("delta", "pmax", "allgather"))
        # At R 2 the ring's 2(R-1) state copies equal allgather's R(R-1).
        if not (d < p and (p < a if r > 2 else p == a)):
            fail(f"bench_merge {cell}: delta < pmax < allgather fails: "
                 f"{d}, {p}, {a}")
    kern = [n for n in rows if n.startswith("kernel/delta_apply/")]
    if sorted(kern) != ["kernel/delta_apply/cuda/K4096_D128_Dc256",
                        "kernel/delta_apply/ref/K4096_D128_Dc256"]:
        fail(f"bench_merge kernel rows: {kern}")
    if counts["delta_apply"] <= 0:
        fail("bench_merge ran no delta_apply kernel")
    return {"rows": lines, "launches": counts, "wall_s": wall}


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
        xk, ak, _ = blocks.block_apply(kind, lp, cfg, x, ctx,
                                       {k: t.clone() for k, t in lc.items()})
        xr, ar, _ = blocks.block_apply(kind, lp, cfg, x,
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


def _serve(cfg, params, impl, widths=None, **kw):
    """The workload's 16 requests through its scheduler; returns (engine,
    requests, wall s, launch counts of this run).  ``widths``, a list,
    gets each mixed step's width C."""
    from repro_torch.kernels import ops
    eng = workload.engine(cfg, params, impl=impl, device="cuda", **kw)
    if widths is not None:
        inner = eng._mixed

        def probe(params_, cache, toks, *rest):
            widths.append(int(toks.shape[1]))
            return inner(params_, cache, toks, *rest)
        eng._mixed = probe
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
    results, streams = {}, {}
    eng, reqs, wall, counts = _serve(cfg, params, "kernel")
    if counts["paged_chunk_attention"] <= 0:
        fail("the scheduler never launched paged_chunk_attention")
    streams["off"] = reqs
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
    streams["int8"] = reqs

    results["engine_dense"] = _engine_generate(cfg, params, False,
                                               "decode_attention")
    results["engine_paged"] = _engine_generate(cfg, params, True,
                                               "paged_decode_attention")
    results["first_step_logits"] = _first_step_errors(cfg, params,
                                                      OLMO_ROUTES)
    results["init_s"] = init_s
    return cfg, params, results, streams


def mla_serving_phase():
    """The MLA workload (``workload.mla_config()``, full width): the
    scheduler on bf16 and on int8 latent pools, ``Engine.generate`` on the
    dense and the paged latent cache, and the first-step kernel-vs-plain
    logits of the two paged routes."""
    cfg = workload.mla_config()
    params, init_s = _init_params(cfg)
    results, streams = {}, {}
    for quant, kernel, name in (("off", "paged_mla_chunk", "scheduler"),
                                ("int8", "paged_mla_chunk_quant",
                                 "scheduler_int8")):
        eng, reqs, wall, counts = _serve(cfg, params, "kernel",
                                         kv_quant=quant)
        if counts[kernel] <= 0:
            fail(f"the MLA {name} never launched {kernel}")
        _check_answered(cfg, eng, reqs, f"MLA {name}")
        results[name] = _serve_report(eng, wall, counts)
        streams[quant] = reqs
    # The dense latent cache runs no kernel (plain matmuls, as in JAX).
    results["engine_dense"] = _engine_generate(cfg, params, False, None)
    results["engine_paged"] = _engine_generate(cfg, params, True,
                                               "paged_mla_decode")
    results["first_step_logits"] = _first_step_errors(cfg, params,
                                                      MLA_ROUTES)
    results["init_s"] = init_s
    return cfg, params, results, streams


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
    streams = {"off": reqs}
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
    return cfg, params, results, streams


def whisper_phase():
    """The whisper workload (``workload.WHISPER``, full width):
    ``Engine.generate`` with the stub frames through the kernels and
    through the plain versions, with its launch counts; then the encoder
    output, the prefill logits and one decode step's logits of the kernel
    path against the plain path from the same state."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    cfg = configs.get(workload.WHISPER_ARCH)
    params, init_s = _init_params(cfg)
    tokens, frames = workload.whisper_inputs(cfg, device="cuda")
    b, new = workload.WHISPER["batch"], workload.WHISPER_NEW
    results, streams = {"init_s": init_s}, {}
    for impl in ("kernel", "ref"):
        eng = workload.whisper_engine(cfg, params, impl=impl, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t = time.perf_counter()
        out = eng.generate(tokens, new, enc_frames=frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = ops.launch_counts()
        streams[impl] = out.cpu().numpy()
        if streams[impl].shape != (b, new) or not (
                (streams[impl] >= 0) & (streams[impl] < cfg.vocab_size)).all():
            fail(f"whisper Engine.generate ({impl}) gave "
                 f"{streams[impl].shape} tokens out of range")
        results[impl] = dict(
            rows=b, prompt_len=workload.WHISPER_PROMPT, steps=new,
            wall_s=wall, tokens_per_s=b * new / wall,
            peak_mem_bytes=torch.cuda.max_memory_allocated(),
            launches=counts)
        del eng
    want = {"flash_attention": cfg.encoder.num_layers,
            "decode_attention": cfg.num_layers * (new - 1)}
    got = {k: results["kernel"]["launches"][k] for k in want}
    if got != want or any(results["ref"]["launches"].values()):
        fail(f"whisper launches {got}, expected {want} (the plain run: "
             f"{results['ref']['launches']})")
    results["greedy_agree_share"] = _agree_share(streams["kernel"],
                                                 streams["ref"])

    enc = {impl: lm._encode(params, cfg, frames, impl)
           for impl in ("kernel", "ref")}
    enc_err = float((enc["kernel"].float() - enc["ref"].float()).abs().max())
    if not enc_err <= LOGITS_ATOL:
        fail(f"whisper encoder output: kernel path against the plain path "
             f"max_abs_err {enc_err}")
    caches, logits = {}, {}
    for impl in ("kernel", "ref"):
        cache = lm.init_cache(cfg, b, workload.WHISPER["max_len"],
                              device="cuda")
        logits[impl], caches[impl] = lm.prefill(
            params, cfg, tokens, cache, impl=impl, enc_frames=frames)
    first = {"prefill": _compare_logits(logits["kernel"], logits["ref"])}
    tok = logits["ref"].argmax(-1)
    pos = torch.full((b,), workload.WHISPER_PROMPT, dtype=torch.int32,
                     device="cuda")
    twin = _clone(caches["ref"])
    lk, _ = lm.decode_step(params, cfg, tok, caches["ref"], pos,
                           impl="kernel")
    lr, _ = lm.decode_step(params, cfg, tok, twin, pos, impl="ref")
    first["decode_attention"] = _compare_logits(lk, lr)
    for name, c in first.items():
        if not (np.isfinite(c["max_abs_err"])
                and c["max_abs_err"] <= LOGITS_ATOL
                and c["clear_rows_agree"]):
            fail(f"whisper first-step logits ({name}): kernel path against "
                 f"the plain path {c}")
    results.update(encoder_max_abs_err=enc_err, first_step_logits=first)
    return results


def _step_pair(params, cfg, cache, tok, pos) -> dict:
    """One decode step through the kernels and one through the plain
    versions, from clones of ``cache``: their logits compared."""
    from repro_torch.models import lm
    twin = _clone(cache)
    lk, _ = lm.decode_step(params, cfg, tok, _clone(cache), pos,
                           impl="kernel")
    lr, _ = lm.decode_step(params, cfg, tok, twin, pos, impl="ref")
    return _compare_logits(lk, lr)


def _logits_hold(label, checks) -> None:
    for name, c in checks.items():
        if not (np.isfinite(c["max_abs_err"])
                and c["max_abs_err"] <= LOGITS_ATOL
                and c["clear_rows_agree"]):
            fail(f"{label} logits ({name}): kernel path against the plain "
                 f"path {c}")


def paligemma_phase():
    """The PaliGemma workload (``workload.PALIGEMMA``, full width): on a
    dense and on a paged cache, ``Engine.generate`` with the stub patch
    embeddings through the kernels (``decode_attention`` /
    ``paged_decode_attention`` at head_dim 256, one launch a layer a
    decode step) and through the plain versions; tokens in range, the
    greedy streams' agreement; then, from the prefill's state, the first
    decode step and a mid-run one (after 16 kernel-path steps) through the
    kernels against the plain path, and the device time of one decode
    step."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import attention, lm
    cfg = configs.get(workload.PALIGEMMA_ARCH)
    params, init_s = _init_params(cfg)
    tokens, prefix = workload.paligemma_inputs(cfg, device="cuda")
    b, new = workload.PALIGEMMA["batch"], workload.PALIGEMMA_NEW
    fill = workload.PALIGEMMA_PROMPT + cfg.num_prefix_tokens
    results = {"init_s": init_s, "params": cfg.param_count(),
               "prefix": list(prefix.shape)}
    for paged, kernel in ((False, "decode_attention"),
                          (True, "paged_decode_attention")):
        key = "paged" if paged else "dense"
        streams, runs = {}, {}
        for impl in ("kernel", "ref"):
            eng = workload.paligemma_engine(cfg, params, paged=paged,
                                            impl=impl, device="cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t = time.perf_counter()
            out = eng.generate(tokens, new, prefix_embeds=prefix)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            counts = ops.launch_counts()
            streams[impl] = out.cpu().numpy()
            if streams[impl].shape != (b, new) or not (
                    (streams[impl] >= 0)
                    & (streams[impl] < cfg.vocab_size)).all():
                fail(f"PaliGemma Engine(paged={paged}, {impl}) gave "
                     f"{streams[impl].shape} tokens out of range")
            if int(eng.pos.max()) != fill + new - 1:
                fail(f"PaliGemma Engine(paged={paged}) ended at pos "
                     f"{int(eng.pos.max())}, not {fill + new - 1}")
            runs[impl] = dict(
                rows=b, prefix_len=cfg.num_prefix_tokens,
                prompt_len=workload.PALIGEMMA_PROMPT, steps=new,
                wall_s=wall, tokens_per_s=b * new / wall,
                peak_mem_bytes=torch.cuda.max_memory_allocated(),
                launches=counts)
            del eng
        want = cfg.num_layers * (new - 1)
        if (runs["kernel"]["launches"][kernel] != want
                or any(runs["ref"]["launches"].values())):
            fail(f"PaliGemma Engine(paged={paged}) launched {kernel} "
                 f"{runs['kernel']['launches'][kernel]} times, expected "
                 f"{want} (the plain run: {runs['ref']['launches']})")
        runs["greedy_agree_share"] = _agree_share(streams["kernel"],
                                                  streams["ref"])
        # Kernel path against the plain path from one state: the first
        # decode step after the prefill, and one after 16 more steps.
        cache = lm.init_cache(cfg, b, workload.PALIGEMMA["max_len"],
                              paged=paged,
                              page_size=workload.PALIGEMMA["page_size"],
                              device="cuda")
        if paged:
            cache = lm.set_block_tables(cache, attention.default_block_tables(
                b, workload.PALIGEMMA["max_len"],
                workload.PALIGEMMA["page_size"], "cuda"))
        logits, cache = lm.prefill(params, cfg, tokens, cache,
                                   prefix_embeds=prefix)
        tok = logits.argmax(-1).to(torch.int32)
        pos = torch.full((b,), fill, dtype=torch.int32, device="cuda")
        checks = {"first_step": _step_pair(params, cfg, cache, tok, pos)}
        for _ in range(16):
            logits, cache = lm.decode_step(params, cfg, tok, cache, pos)
            tok, pos = logits.argmax(-1).to(torch.int32), pos + 1
        checks["mid_run"] = _step_pair(params, cfg, cache, tok, pos)
        _logits_hold(f"PaliGemma Engine(paged={paged})", checks)
        runs["logits"] = checks
        # One decode step's device time (it rewrites slot pos each call),
        # and its attention's: the kernel, with its write on pages.
        step = _clone(cache)
        us = device_kernel_us(
            lambda: lm.decode_step(params, cfg, tok, step, pos), iters=5)
        attn = ("dense_attend", "chunk_mma", "chunk_combine", "write_tokens")
        runs["decode_step_device_ms"] = sum(us.values()) / 1e3
        runs["decode_step_attention_device_ms"] = sum(
            v for n, v in us.items() if any(a in n for a in attn)) / 1e3
        runs["decode_step_top_kernels"] = [
            [n[:80], v / 1e3] for n, v in sorted(
                us.items(), key=lambda kv: -kv[1])[:5]]
        results[key] = runs
    return results


def long_prompt_phase():
    """The long-prompt workload (``workload.LONG``): OLMo-1B prefills one
    prompt of 16,384 tokens through the blockwise path (past
    ``lm.CHUNKED_THRESHOLD``) and decodes ``LONG_NEW`` tokens on a dense
    cache through the kernels and through the plain versions; the first
    decode step through the kernels against the plain path from the
    prefill's state.  Before it, on one layer's q / k / v of a 9,216-token
    prompt (past the threshold, and short enough for the masked path's
    float32 scores, 5.4 GB), ``attention._sdpa_chunked`` against the
    masked ``attention._sdpa``: bf16 under the bf16 rule, float32 within
    1e-5."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import attention, common, lm
    from repro_torch.serving.engine import Engine
    cfg = configs.get(workload.ARCH)
    params, init_s = _init_params(cfg)
    results = {"init_s": init_s}
    t = 9216
    if lm._make_ctx(cfg, t, "cuda").chunked is not True:
        fail(f"a {t}-token prompt does not take the blockwise path")
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, t)), device="cuda")
    layer = params["layers"][0]
    h = common.apply_norm(layer["norm1"], lm._embed(params, cfg, toks),
                          cfg.norm_type, cfg.norm_eps)
    q, k, v = attention._qkv(layer["attn"], cfg, h,
                             torch.arange(t, device="cuda"))
    scale = cfg.head_dim ** -0.5
    mask = common.make_mask(t, t, causal=True, device="cuda")
    sdpa = {}
    for dtype in (torch.bfloat16, torch.float32):
        qd, kd, vd = (x.to(dtype) for x in (q, k, v))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = attention._sdpa_chunked(qd, kd, vd, scale)
        torch.cuda.synchronize()
        chunked_s = time.perf_counter() - t0
        want = attention._sdpa(qd, kd, vd, mask, scale)
        err = float((got.float() - want.float()).abs().max())
        share = float(((got.float() - want.float()).abs()
                       / (KERNEL_ATOL + KERNEL_RTOL * want.float().abs()
                          if dtype == torch.bfloat16 else
                          1e-5 + 1e-5 * want.float().abs())).max())
        if not share <= 1:
            fail(f"_sdpa_chunked against the masked _sdpa ({dtype}): "
                 f"max_abs_err {err}, {share} of the rule")
        sdpa[str(dtype).split(".")[1]] = dict(
            max_abs_err=err, rule_share=share, chunked_s=chunked_s)
        del got, want, qd, kd, vd
        torch.cuda.empty_cache()
    results["sdpa_chunked_vs_masked"] = dict(tokens=t, **sdpa)
    del q, k, v, h, mask
    torch.cuda.empty_cache()

    prompt = workload.long_prompt(cfg.vocab_size)
    new = workload.LONG_NEW
    streams = {}
    for impl in ("kernel", "ref"):
        eng = Engine(cfg, params, **workload.LONG, impl=impl, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        eng.prefill(prompt)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        outs = [eng.token]
        t0 = time.perf_counter()
        for _ in range(new - 1):
            outs.append(eng.step())
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        streams[impl] = torch.stack(outs, 1).cpu().numpy()
        results[impl] = dict(
            prompt_len=workload.LONG_PROMPT, steps=new, prefill_s=prefill_s,
            prefill_tokens_per_s=workload.LONG_PROMPT / prefill_s,
            decode_s=decode_s, decode_tokens_per_s=(new - 1) / decode_s,
            peak_mem_bytes=torch.cuda.max_memory_allocated(),
            launches=ops.launch_counts())
        if impl == "kernel":
            cache, tok, pos = _clone(eng.cache), outs[0], torch.full(
                (1,), workload.LONG_PROMPT, dtype=torch.int32,
                device="cuda")
        del eng
    want = cfg.num_layers * (new - 1)
    if (results["kernel"]["launches"]["decode_attention"] != want
            or any(results["ref"]["launches"].values())):
        fail(f"the long prompt's decode launched decode_attention "
             f"{results['kernel']['launches']['decode_attention']} times, "
             f"expected {want} (the plain run: "
             f"{results['ref']['launches']})")
    if (streams["kernel"][:, 0] != streams["ref"][:, 0]).any():
        fail("the long prompt's prefill gave two first tokens")
    results["greedy_agree_share"] = _agree_share(streams["kernel"],
                                                 streams["ref"])
    first = {"first_step": _step_pair(params, cfg, cache, tok, pos)}
    _logits_hold("long prompt", first)
    results["logits"] = first
    return results


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
    if first and device != "cpu":
        report.update(_pull_host_ms(server, first))
    return dict(report=report, server=server, reqs=reqs)


def _pull_host_ms(server, first, iters: int = 20) -> dict:
    """Host ms of the first pull's page move again, once the run is over:
    ``copy_pages_across`` from the exporter's cache into the adopter's,
    and ``export_pages`` of the page (the snapshot a pull takes for its
    rollback), each ended by a synchronize."""
    from repro_torch.models import cache as cache_mod
    src = server.engines[first["exporter"]].cache
    dst = server.engines[first["adopter"]].cache
    page = [first["page"]]
    return dict(pull_host_ms=host_ms(lambda: cache_mod.copy_pages_across(
                    src, dst, page, impl=server.impl), iters),
                export_host_ms=host_ms(lambda: cache_mod.export_pages(
                    dst, page), iters))


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
            fail(f"streams ({label}): request {ra.rid} differs at token "
                 f"{j} where the top-2 gap is {gap}")
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
        xk, ak, _ = blocks.block_apply(kind, lp, cfg, x, ctx, ak)
        xr, ar, _ = blocks.block_apply(kind, lp, cfg, x,
                                       ctx._replace(impl="ref"), ar)
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
               spec_decode=r.spec_decode, draft_tokens=r.draft_tokens,
               accepted_tokens=r.accepted_tokens,
               rollback_tokens=r.rollback_tokens,
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


# ---------------------------------------------------------------------------
# The paper's tables on the sim LLM
# ---------------------------------------------------------------------------

TABLE_TASKS = ["tic_tac_toe", "dashboard"]


def tables_phase() -> dict:
    """``benchmarks.common.run_suite`` on the card (the agents' sim LLM:
    reduced OLMo-1B, d_model 64, 4 heads of 16, a dense cache replayed
    token by token, so its decode steps run ``decode_attention`` at head
    dim 16): one run a mode on two tasks with 4 agents, its cache file in
    a temporary directory.  Every trial must converge and
    ``decode_attention`` must launch; the table 3, 4, 5, 7 and RQ3 rows
    are returned (their wall figures are host-bound)."""
    import tempfile
    from pathlib import Path

    from repro_torch.benchmarks import common, tables
    from repro_torch.kernels import ops
    common.sim_llm("cuda")
    keep = common.RESULTS_DIR
    with tempfile.TemporaryDirectory() as tmp:
        common.RESULTS_DIR = Path(tmp)
        try:
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t = time.perf_counter()
            suite = common.run_suite(runs_per_mode=1, n_agents=4,
                                     tasks=TABLE_TASKS, force=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            counts = ops.launch_counts()
        finally:
            common.RESULTS_DIR = keep
    trials = [r for modes in suite.values() for rs in modes.values()
              for r in rs]
    if len(trials) != 2 * len(TABLE_TASKS) or not all(
            r.converged for r in trials):
        fail(f"the tables' trials did not all converge: "
             f"{[(r.task, r.mode, r.converged) for r in trials]}")
    if counts["decode_attention"] <= 0:
        fail("the tables' trials never launched decode_attention")
    rows = (tables.table3(suite) + tables.table4(suite)
            + tables.table5(suite) + tables.table7(suite)
            + tables.rq3_consistency(suite))
    return dict(rows=rows, trials=len(trials), wall_s=wall,
                steps=sum(r.steps for r in trials), launches=counts)


# ---------------------------------------------------------------------------
# The serving benchmark and the examples
# ---------------------------------------------------------------------------

# The kernels the serving benchmark's sweeps can reach: the schedulers'
# mixed steps (bf16 and quantized pools), the quant-error report's decode
# steps, the disaggregated server's page moves.  The sweeps' dense rows run
# the mixed step's masked path, so decode_attention stays at 0 (as in
# JAX's bench, whose dense mixed step is a masked einsum too).
BENCH_KERNELS = ("paged_chunk_attention", "paged_decode_attention",
                 "paged_chunk_attention_quant",
                 "paged_decode_attention_quant", "page_transfer")
BENCH_FLAGS = ("admission", "replication", "fault_tolerance",
               "disaggregation", "quantization", "memory_tiers",
               "speculation")
# The two flags JAX's own bench computes false at its full sizes, on the
# same workload (checked with the JAX package's functions on the CPU): its
# second crash step (8) finds no request in flight on the crashed replica,
# so there is nothing to recover; and int8 pools part the greedy streams
# from bf16's at 16 new tokens over 119-token prompts (ROADMAP queue 3:
# int8 streams do not equal the reference's in the engine).  The quick
# run, which the gate reads, must have every flag true.
FULL_SIZE_FALSE = ("fault_tolerance.crash_runs_recovered",
                   "quantization.streams_match_int8")
# The bench's greedy-identity flags between int8 and bf16 pools.  On the
# card the two pools' kernels round differently, and the sim LLM has exact
# logit ties (512 tokens over 64 widths), so a tie may break either way
# (ROADMAP queue 3: int8 streams are gated on the logit error, not on
# identity).  Where one is false, it is held to the card's tie-aware rule
# instead (``_int8_ties``): every greedy token that differs does so where
# the bf16 pool's top-2 gap is at most ``TIE_GAP``, the bound the CPU
# tests hold the same model to (``tests/torch_agents_common.py``).
INT8_IDENTITY = ("quantization.streams_match_int8",
                 "quantization.greedy_match_int8")
TIE_GAP = 0.125
EXAMPLES = (("quickstart",), ("multi_agent_codegen", "tic_tac_toe", "2"),
            ("serve_demo",))


def _bench_flags(report) -> dict:
    """Every acceptance flag of a bench report, by section."""
    return {f"{sec}.{k}": v for sec in BENCH_FLAGS
            for k, v in report[sec].items() if isinstance(v, bool)}


def _int8_ties(report, false: list) -> dict:
    """The false int8 identity flags of one run, judged on the gaps that
    run's report holds: each teacher-forced step of the quant-error report
    and each sweep stream that parts from the bf16 pool's does so at a
    bf16 top-2 gap of at most ``TIE_GAP``."""
    out = {}
    if "quantization.greedy_match_int8" in false:
        out["teacher_forced"] = \
            report["quant_error"]["modes"]["int8"]["flip_gaps"]
    if "quantization.streams_match_int8" in false:
        out["streams"] = [g for r in report["quant"]
                          if r["kv_quant"] == "int8"
                          for g in r["first_diff_gaps"]]
    for key, gaps in out.items():
        if not gaps or max(gaps) > TIE_GAP:
            fail(f"int8 {key} part from the bf16 pool's at top-2 gaps "
                 f"{gaps} (a tie is a gap of at most {TIE_GAP})")
    return out


# The gate's lines that follow from the generated tokens: the speculative
# sweeps' draft and rollback counts (a drafter proposes from the stream so
# far, so a tie broken otherwise drafts and rolls back other spans; the
# card moved ``spec ngram rollback_tokens`` 4 -> 6) and the int8 identity
# flags.  The card's kernels break the sim LLM's exact logit ties
# otherwise than the CPU's plain path, so these move between the two
# devices with no change of code (the gate's premise, bit-identical
# reruns, holds on one device).  On the card they are held instead to
# that device's own rules: every speculative stream equal to the card's
# greedy stream and the agents' digests equal (flags that must be true),
# and the int8 identity flags tie-aware (``_int8_ties``).  Every other
# speculative line (steps, acceptance, µs an accepted token) must pass.
TOKEN_COUNTERS = ("draft_tokens", "rollback_tokens")
INT8_GATE_LINES = ("int8 greedy streams identical to bf16 pools: FAIL",
                   "int8 teacher-forced argmax matches reference: FAIL")


def gate_against_cpu(report, baseline) -> dict:
    """``check_regression.check`` of a card report against the CPU
    baseline: the failed lines (missing rows included) that must not
    fail, and the token-dependent ones, kept apart.  The per-counter
    table at the end only sums the lines above it."""
    from repro_torch.benchmarks import check_regression
    ok, lines = check_regression.check(baseline, report, 0.15, 0.50)
    lines = lines[:lines.index("per-counter gate table:")]
    bad = [l.strip() for l in lines if "FAIL" in l or "MISSING" in l]
    token = [l for l in bad if l in INT8_GATE_LINES
             or (l.startswith(("spec ", "spec-agents "))
                 and l.split(":")[0].split()[-1] in TOKEN_COUNTERS)]
    return dict(ok=ok, lines=len(lines), token_dependent=token,
                failed=[l for l in bad if l not in token])


def _paged_over_dense(report) -> dict:
    """µs a token of each paged row over its dense row's (the gate's
    normalized timing)."""
    us = {(r["mode"], r["batch"], r["skew"]): r["us_per_token"]
          for r in report["rows"]}
    return {f"b{b}_{skew}": us[("paged", b, skew)] / us[("dense", b, skew)]
            for (mode, b, skew) in us if mode == "paged"}


def _bench_analytic(report) -> dict:
    """The analytic counters of a quick report: functions of the cache
    trees' shapes and of the schedule, the same on every device."""
    out = {}
    for r in report["rows"]:
        for k in ("write_bytes_per_step", "read_bytes_per_step",
                  "resident_cache_mb"):
            out[f"rows/{r['mode']}_b{r['batch']}_{r['skew']}/{k}"] = r[k]
    for r in report["quant"]:
        for k in ("write_bytes_per_step", "read_bytes_per_step",
                  "resident_cache_mb", "slot_bytes"):
            out[f"quant/{r['kv_quant']}/{k}"] = r[k]
    for r in report["prefix_share"]:
        out[f"prefix/f{r['fanout']}_{r['cow']}/resident_cache_mb"] = \
            r["resident_cache_mb"]
    for r in report["disagg"]:
        for k in ("transfer_bytes", "transfer_bytes_per_step"):
            out[f"disagg/{r['adoption']}/{k}"] = r[k]
    return out


def _examples() -> dict:
    """The three examples as subprocesses with ``--device cuda``, run
    together; each must exit 0."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t = time.perf_counter()
    procs = {args[0]: subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.examples.{args[0]}",
         *args[1:], "--device", "cuda"], cwd=HERE, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for args in EXAMPLES}
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            if proc.returncode != 0:
                fail(f"example {name} exited {proc.returncode}: "
                     f"{stderr[-1500:]}")
            out[name] = dict(rc=proc.returncode,
                             last_line=stdout.strip().splitlines()[-1])
    finally:
        for proc in procs.values():
            proc.kill()
    out["wall_s"] = time.perf_counter() - t
    return out


def serving_bench_phase(card) -> dict:
    """The port's serving benchmark on the card, at JAX's default sizes
    and at ``--quick``; the quick report through the regression gate
    against the CPU baseline, its analytic counters equal to the
    baseline's, every flag true, the MHA kernels and ``page_transfer``
    launched; then the three examples."""
    import tempfile

    from repro_torch.benchmarks import bench_serving, check_regression
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, quick in (("full", False), ("quick", True)):
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t = time.perf_counter()
            csv = []
            report = bench_serving.run_bench(
                quick=quick, out=os.path.join(tmp, f"{label}.json"),
                emit_csv=csv.append, device="cuda")
            torch.cuda.synchronize()
            runs[label] = dict(report=report, csv=csv,
                               wall_s=time.perf_counter() - t,
                               launches=ops.launch_counts())
    false = {label: sorted(k for k, v in _bench_flags(run["report"]).items()
                           if not v) for label, run in runs.items()}
    allowed = dict(quick=INT8_IDENTITY, full=FULL_SIZE_FALSE + INT8_IDENTITY)
    bad = {label: [k for k in keys if k not in allowed[label]]
           for label, keys in false.items()}
    if any(bad.values()):
        fail(f"serving bench acceptance flags false: {bad}")
    ties = {label: _int8_ties(runs[label]["report"], false[label])
            for label in runs}
    baseline = json.loads(check_regression.BASELINE.read_text())
    quick = runs["quick"]["report"]
    gate = gate_against_cpu(quick, baseline)
    if gate["failed"]:
        fail("serving bench regression gate against the CPU baseline: "
             + "; ".join(gate["failed"]))
    want, got = _bench_analytic(baseline), _bench_analytic(quick)
    diff = {k: (got.get(k), v) for k, v in want.items() if got.get(k) != v}
    if diff or set(got) != set(want):
        fail(f"serving bench analytic counters differ from the CPU "
             f"baseline's: {diff}")
    launches = runs["full"]["launches"]
    for name in BENCH_KERNELS:
        if launches[name] <= 0:
            fail(f"the serving bench never launched {name}")
    examples = _examples()
    return dict(
        full_s=runs["full"]["wall_s"], quick_s=runs["quick"]["wall_s"],
        launches=launches, quick_launches=runs["quick"]["launches"],
        flags={label: len(_bench_flags(run["report"]))
               for label, run in runs.items()}, false_flags=false,
        int8_ties=ties,
        gate=gate, analytic_counters=len(want),
        paged_over_dense=dict(card=_paged_over_dense(quick),
                              cpu_baseline=_paged_over_dense(baseline)),
        csv={label: run["csv"] for label, run in runs.items()},
        examples=examples, phase_s=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# Speculative decoding at full width
# ---------------------------------------------------------------------------

SPEC_STATS = ("draft_tokens", "accepted_tokens", "rollback_tokens",
              "spec_steps", "spec_rollbacks")


class _OracleDrafter:
    """Proposes the continuation of a request's non-speculative stream
    (found by its context as a prefix of prompt + tokens): what a drafter
    that is always right would propose."""

    name = "oracle"

    def __init__(self, reqs):
        self._full = [list(r.prompt) + list(r.tokens) for r in reqs]

    def propose(self, context, k):
        n = len(context)
        for full in self._full:
            if len(full) > n and full[:n] == context:
                return full[n:n + k]
        return []


def _snapshot_cost(eng) -> dict:
    """Device and host ms of one rollback snapshot (``snapshot_span`` at
    width 8, every pool and scale leaf of the engine's cache)."""
    from repro_torch.models import cache as cache_mod
    start = torch.arange(100, 100 + 96 * B, 96, dtype=torch.int32,
                         device="cuda")

    def snap():
        return cache_mod.snapshot_span(eng.cache, start, 8)
    leaves = sum(len(x) for x in snap()["layers"])
    return dict(snapshot_leaves=leaves,
                snapshot_device_ms=kernel_device_ms(snap, ""),
                snapshot_host_ms=host_ms(snap))


def _spec_run(cfg, params, name, base, base_report, kernel, *, cost=False,
              **kw) -> dict:
    """The workload's 16 requests with speculative decoding (``ngram``
    unless a ``drafter`` is given): answered, drafts proposed, ``kernel``
    launched, the streams tie-aware to the same pools' non-spec run
    ``base``; steps and tokens/s beside that run's."""
    host = {"draft_host_s": 0.0, "snapshot_host_s": 0.0,
            "restore_host_s": 0.0}

    def timed(fn, key):
        def call(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                host[key] += time.perf_counter() - t
        return call

    def engine(*a, **k):
        eng = kept[0](*a, **k)
        eng.drafter.propose = timed(eng.drafter.propose, "draft_host_s")
        return eng

    from repro_torch.models import lm
    kept = workload.engine, lm.rollback_snapshot, lm.rollback_restore
    workload.engine = engine
    lm.rollback_snapshot = timed(lm.rollback_snapshot, "snapshot_host_s")
    lm.rollback_restore = timed(lm.rollback_restore, "restore_host_s")
    try:
        eng, reqs, wall, counts = _serve(cfg, params, "kernel",
                                         spec_decode="ngram", **kw)
    finally:
        workload.engine, lm.rollback_snapshot, lm.rollback_restore = kept
    _check_answered(cfg, eng, reqs, name)
    st = eng.stats
    if not (st["draft_tokens"] > 0 and st["spec_steps"] > 0):
        fail(f"spec run {name} drafted nothing: {st}")
    if counts[kernel] <= 0:
        fail(f"spec run {name} never launched {kernel}")
    report = dict(_serve_report(eng, wall, counts),
                  **{k: st[k] for k in SPEC_STATS},
                  accept_rate=eng.spec_accept_rate,
                  base_steps=base_report["steps"],
                  base_tokens_per_s=base_report["tokens_per_s"], **host,
                  streams=_streams_tie_aware(cfg, params, reqs, base, name))
    if cost:
        report.update(_snapshot_cost(eng))
    emit({"spec_run": name, **{k: report[k] for k in (
        "steps", "base_steps", "accept_rate", "draft_tokens",
        "accepted_tokens", "tokens_per_s", "base_tokens_per_s", "wall_s",
        "draft_host_s", "snapshot_host_s", "restore_host_s")}})
    return report


def _spec_step_check(cfg, params) -> dict:
    """One captured spec step of the OLMo int8 workload, from the first
    state whose verify step carries drafts and then rolls a tail back:
    the verify step through the kernels against ``impl="ref"`` from the
    same state (all-position logits within ``LOGITS_ATOL``, argmax equal
    wherever the plain top-2 gap exceeds twice that); after the step's
    rollback, every rejected-tail slot of every pool and scale leaf holds
    its pre-verify bytes, slots on the trash page aside."""
    from repro_torch.models import cache as cache_mod, lm
    eng = workload.engine(cfg, params, impl="kernel", device="cuda",
                          kv_quant="int8", spec_decode="ngram")
    fund, verify = eng._fund_drafts, eng._verify
    cur = {}

    def funding(spans):
        cur["drafts"] = fund(spans)
        return cur["drafts"]

    def verifying(params_, cache, toks, start, span):
        if cur.get("drafts") and "pre" not in cur:
            cur.update(pre=_clone(cache), toks=toks.clone(),
                       start=start.clone(), span=span.clone(),
                       before={r: len(eng.rows[r].tokens)
                               for r in cur["drafts"]},
                       reqs={r: eng.rows[r] for r in cur["drafts"]})
        return verify(params_, cache, toks, start, span)

    eng._fund_drafts, eng._verify = funding, verifying
    for r in workload.requests(cfg.vocab_size):
        eng.submit(r)
    while True:
        rolled = eng.stats["spec_rollbacks"]
        cur.clear()
        more = eng.step()
        if "pre" in cur and eng.stats["spec_rollbacks"] > rolled:
            break
        if not more:
            fail("the int8 spec run reached no step that rolled back")
    pre, toks, start, span = (cur[k] for k in ("pre", "toks", "start",
                                               "span"))
    c = toks.shape[1]
    live = torch.arange(c, device="cuda")[None, :] < span[:, None]
    lk, _ = lm.mixed_step(params, cfg, toks, _clone(pre), start, span,
                          impl="kernel", all_logits=True)
    lr, _ = lm.mixed_step(params, cfg, toks, _clone(pre), start, span,
                          impl="ref", all_logits=True)
    out = _compare_logits(lk[live], lr[live])
    # The pools as the step left them, read through the tables the step
    # wrote with (the host has freed the tail pages since).
    view = {"layers": [dict(lc, block_tables=lp["block_tables"])
                       if "block_tables" in lc else lc
                       for lc, lp in zip(eng.cache["layers"],
                                         pre["layers"])]}
    post = cache_mod.snapshot_span(view, start, c)
    want = cache_mod.snapshot_span(pre, start, c)
    bt = lm.get_block_tables(pre).cpu()
    st, sp = start.cpu().tolist(), span.cpu().tolist()
    slots, equal = 0, True
    for r, req in cur["reqs"].items():
        n_app = len(req.tokens) - cur["before"][r]
        for w in range(n_app, sp[r]):
            if int(bt[r, (st[r] + w) // PS]) == eng.trash_page:
                continue
            slots += 1
            for lp, lw in zip(post["layers"], want["layers"]):
                for name in lp:
                    equal &= torch.equal(_bits(lp[name][r, w:w + 1]),
                                         _bits(lw[name][r, w:w + 1]))
    out.update(spans=sp, drafts={r: len(d) for r, d in cur["drafts"].items()},
               accepted={r: len(req.tokens) - cur["before"][r] - 1
                         for r, req in cur["reqs"].items()},
               rolled_back_slots=slots, rollback_bitwise=equal,
               step=eng.stats["steps"])
    if not (slots > 0 and equal and np.isfinite(out["max_abs_err"])
            and out["max_abs_err"] <= LOGITS_ATOL
            and out["clear_rows_agree"]):
        fail(f"captured spec step: {out}")
    return out


def olmo_spec_phase(cfg, params, serving, streams) -> dict:
    """OLMo-1B's spec runs: bf16 pools ``ngram`` (and the snapshot's
    cost), bf16 pools with the oracle drafter, int8 pools ``ngram``; then
    the captured int8 spec step."""
    out = {"bf16_ngram": _spec_run(
        cfg, params, "olmo bf16 ngram", streams["off"],
        serving["scheduler"], "paged_chunk_attention", cost=True)}
    oracle = _spec_run(cfg, params, "olmo bf16 oracle", streams["off"],
                       serving["scheduler"], "paged_chunk_attention",
                       drafter=_OracleDrafter(streams["off"]))
    if not (oracle["accepted_tokens"] > 0
            and oracle["steps"] < oracle["base_steps"]):
        fail(f"the oracle drafter's run did not take fewer steps: {oracle}")
    out["bf16_oracle"] = oracle
    out["int8_ngram"] = _spec_run(
        cfg, params, "olmo int8 ngram", streams["int8"],
        serving["scheduler_int8"], "paged_chunk_attention_quant",
        cost=True, kv_quant="int8")
    out["captured_int8_step"] = _spec_step_check(cfg, params)
    return out


def mla_spec_phase(cfg, params, serving, streams) -> dict:
    """The MLA workload's spec runs on bf16 and int8 latent pools."""
    return {"bf16_ngram": _spec_run(cfg, params, "mla bf16 ngram",
                                    streams["off"], serving["scheduler"],
                                    "paged_mla_chunk"),
            "int8_ngram": _spec_run(cfg, params, "mla int8 ngram",
                                    streams["int8"],
                                    serving["scheduler_int8"],
                                    "paged_mla_chunk_quant",
                                    kv_quant="int8")}


def recurrent_spec_phase(cfg, params, serving, streams) -> dict:
    """RecurrentGemma-2B's spec run: its verify and committed-span replay
    run ``linear_scan``."""
    return {"ngram": _spec_run(cfg, params, "recurrent ngram",
                               streams["off"], serving["scheduler"],
                               "linear_scan")}


def spec_trial(cfg, params, a) -> dict:
    """Trial run (h): (a)'s configuration with ``spec_decode="doc"``,
    ``spec_k=4`` (drafts from the shared CRDT document); it must converge,
    draft, and launch paged_chunk_attention_quant."""
    from repro_torch.agents.tasks import TASKS
    res = _run_trial(cfg, params, TASKS[TRIAL_TASK], "h",
                     dict(mode="parallel", merge="allgather",
                          spec_decode="doc", spec_k=4))
    if res["draft_tokens"] <= 0:
        fail(f"trial (h) drafted nothing: {res}")
    if res["launches"]["paged_chunk_attention_quant"] <= 0:
        fail("trial (h) never launched paged_chunk_attention_quant")
    emit({"trial_h_vs_a": {k: (res[k], a[k]) for k in (
        "steps", "digest", "accepted_tokens", "draft_tokens", "wall_s",
        "tokens_per_s")}})
    return res


# ---------------------------------------------------------------------------
# The swap tier at full width (OLMo-1B)
# ---------------------------------------------------------------------------

def _swap_round_trip(cfg, params, quant) -> dict:
    """A swap-out / clobber / swap-in round trip of a 512-token context
    (32 pages of row 3 of the workload's tables) on a prefilled paged
    cache: every pool and scale leaf back bitwise, the mirror bitwise to
    the pages; then the host ms (synchronized) of a swap-out and a swap-in
    of those pages."""
    from repro_torch.models import attention, cache as cache_mod, lm
    cache = lm.init_cache(cfg, B, MAX_LEN, paged=True, page_size=PS,
                          kv_quant=quant, device="cuda")
    cache = lm.set_block_tables(cache, attention.default_block_tables(
        B, MAX_LEN, PS, "cuda"))
    prompt = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (B, 512)), device="cuda")
    _, cache = lm.prefill(params, cfg, prompt, cache)
    tier = workload.SWAP["swap_tier_pages"]
    maxp = MAX_LEN // PS
    pages = list(range(3 * maxp, 3 * maxp + 32))
    free = list(range(tier))
    slots = [free.pop() for _ in pages]        # as the scheduler hands out
    pool = cache_mod.make_swap_pool(cache, tier)
    leaves = [(path, layer, name)
              for path, layout, layer in cache_mod.iter_layers(cache)
              for name in cache_mod.pool_leaves(layout)]
    idx = torch.as_tensor(pages, device="cuda")
    before = [_bits(layer[name][idx]) for _, layer, name in leaves]
    moved = cache_mod.swap_out_pages(cache, pool, pages, slots)
    for _, layer, name in leaves:
        layer[name][idx] = layer[name][idx + maxp]   # another row's bytes
    clobbered = sum(not torch.equal(_bits(layer[name][idx]), b)
                    for (_, layer, name), b in zip(leaves, before))
    cache_mod.swap_in_pages(cache, pool, slots, pages)
    torch.cuda.synchronize()
    back = all(torch.equal(_bits(layer[name][idx]), b)
               for (_, layer, name), b in zip(leaves, before))
    mirror = all(torch.equal(_bits(pool[path][name][slots]), b.cpu())
                 for (path, _, name), b in zip(leaves, before))
    if not (back and mirror and clobbered):
        fail(f"swap round trip ({quant}): back bitwise {back}, mirror "
             f"bitwise {mirror}, leaves clobbered {clobbered}")
    out_ms = host_ms(lambda: cache_mod.swap_out_pages(cache, pool, pages,
                                                      slots), iters=10)
    in_ms = host_ms(lambda: cache_mod.swap_in_pages(cache, pool, slots,
                                                    pages), iters=10)
    return dict(kv_quant=quant, leaves=len(leaves), pages=len(pages),
                bytes=moved, leaves_bitwise=back, mirror_bitwise=mirror,
                swap_out_host_ms=out_ms, swap_in_host_ms=in_ms,
                swap_out_gb_per_s=moved / out_ms / 1e6,
                swap_in_gb_per_s=moved / in_ms / 1e6)


SWAP_COUNTERS = ("preemptions", "preempt_swap", "preempt_recompute",
                 "swap_outs", "swap_ins")


def swap_phase(cfg, params) -> dict:
    """The swap workload (``workload.SWAP``: OLMo-1B's 16 requests over 96
    pages): swap off, then a host tier of 256 pages; every request
    answered, no page or slot leaked, swap off preempts by recompute and
    swap on by swap in fewer steps, the streams equal but at near-ties
    (recompute re-admits by chunks, which is not bitwise); then the bf16
    and int8 round trips."""
    out, done = {}, {}
    page_bytes = 0
    for name, tier in (("off", 0), ("on", workload.SWAP["swap_tier_pages"])):
        eng, reqs, wall, counts = _serve(
            cfg, params, "kernel", num_pages=workload.SWAP["num_pages"],
            swap_tier_pages=tier)
        _check_answered(cfg, eng, reqs, f"swap {name}")
        if counts["paged_chunk_attention"] <= 0:
            fail(f"swap {name} never launched paged_chunk_attention")
        st = eng.stats
        rep = dict(_serve_report(eng, wall, counts),
                   **{k: st[k] for k in SWAP_COUNTERS})
        if not (eng.allocator.available == eng.allocator.num_pages
                and sorted(eng._swap_free) == list(range(tier))):
            fail(f"swap {name} leaked: {eng.allocator.available} of "
                 f"{eng.allocator.num_pages} pages free, slots "
                 f"{len(eng._swap_free)} of {tier}")
        if tier:
            page_bytes = sum(t[0].numel() * t.element_size()
                             for leaves in eng.swap_pool.values()
                             for t in leaves.values())
            rep["bytes_swapped_out"] = st["swap_outs"] * page_bytes
        out[name], done[name] = rep, reqs
        emit({"swap_run": name, **{k: v for k, v in rep.items()
                                    if k != "launches"}})
        del eng
        gc.collect()
    off, on = out["off"], out["on"]
    if not (off["preempt_recompute"] > 0 and on["preempt_swap"] > 0
            and on["swap_outs"] == on["swap_ins"] > 0
            and on["steps"] < off["steps"]):
        fail(f"swap runs: off {off}, on {on}")
    out["page_bytes"] = page_bytes
    out["streams_on_vs_off"] = _streams_tie_aware(cfg, params, done["on"],
                                                  done["off"], "swap on/off")
    out["round_trip"] = {q: _swap_round_trip(cfg, params, q)
                         for q in ("off", "int8")}
    return out


# ---------------------------------------------------------------------------
# The MoE family at full width: DeepSeek-V2-Lite and deepseek-moe-16b
# ---------------------------------------------------------------------------

class _Routes:
    """Records every ``moe.route`` call made inside the ``with`` block: the
    router logits (float32 of the bf16 product) and the expert ids.  With
    ``pin`` (expert ids, one tensor a call in order) each call routes to
    the pinned experts instead, its gates renormalised from its own
    probabilities."""

    def __init__(self, pin=None):
        self.pin = None if pin is None else list(pin)

    def __enter__(self):
        from repro_torch.models import common, moe
        self.calls, self._orig = [], moe.route

        def route(p, cfg, xf):
            probs, gates, idx = self._orig(p, cfg, xf)
            if self.pin is not None:
                idx = self.pin.pop(0)
                gates = probs.gather(-1, idx)
                gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
            self.calls.append((common.dense(p["router"], xf).float(), idx))
            return probs, gates, idx
        moe.route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self._orig


def _bf16_step(x: torch.Tensor) -> torch.Tensor:
    """One bf16 step (unit in the last place) at |x|."""
    e = torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


# The routing rule: a token's routed experts through the kernels may
# differ from the plain path's only where the plain path's k-th and
# (k+1)-th router logits are within two bf16 steps of the larger one:
# the attention route moves the FFN input in its last bits, so each
# logit may land one bf16 step away, and two logits one step apart each
# way can swap.
ROUTE_STEPS = 2


def _route_diff(rk, rr, k) -> tuple[torch.Tensor, torch.Tensor]:
    """(tokens whose routed expert sets differ, whether each such token is
    a near-tie by the routing rule on the plain logits)."""
    (lk, ik), (lr, ir) = rk, rr
    diff = (ik.sort(-1).values != ir.sort(-1).values).any(-1)
    top = lr.topk(k + 1, dim=-1).values
    gap = top[:, k - 1] - top[:, k]
    tie = gap <= ROUTE_STEPS * _bf16_step(top[:, k - 1:k + 1].abs()
                                          .max(-1).values)
    return diff, tie


def _moe_route_check(cfg, params) -> dict:
    """The first steps through the kernels against the plain path on a
    paged bf16 latent cache: a decode step (8 tokens: the dense dispatch)
    and a mixed step (chunk 64: the gather dispatch).  Layer by layer from
    the same inputs (the kernel path's hidden state): a token's routed
    experts may differ only by the routing rule; each block's output is
    reported on the rows that route the same.  End to end (each path its
    own): the share of tokens routed differently in some layer, and the
    logits as ``_compare_logits`` on the rows every token of which routes
    the same in every layer; then the plain path again with every layer
    pinned to the kernel path's experts, whose logits on every live row
    must agree as ``_compare_logits`` (what is left is the attention
    route's difference, as in the dense models' first-step check)."""
    from repro_torch.models import attention, blocks, cache as cache_mod, lm
    from repro_torch.models.blocks import BlockCtx
    rng = np.random.default_rng(1)
    k = cfg.moe.top_k
    cache = lm.init_cache(cfg, B, MAX_LEN, paged=True, page_size=PS,
                          device="cuda")
    cache = lm.set_block_tables(cache, attention.default_block_tables(
        B, MAX_LEN, PS, "cuda"))
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, 128)),
                             device="cuda")
    logits, cache = lm.prefill(params, cfg, prompt, cache)
    pos = torch.full((B,), 128, dtype=torch.int32, device="cuda")
    span = torch.as_tensor([64, 33, 1, 1, 0, 64, 17, 2], dtype=torch.int32,
                           device="cuda")
    steps = {"decode": (logits.argmax(-1)[:, None], pos,
                        torch.ones_like(span)),
             "mixed": (torch.as_tensor(rng.integers(
                 0, cfg.vocab_size, (B, CHUNK)), device="cuda"), pos, span)}
    out = {}
    for name, (toks, start, sp) in steps.items():
        c = toks.shape[1]
        live = torch.arange(c, device="cuda")[None, :] < sp[:, None]
        if name == "decode":
            ctx = BlockCtx(positions=start[:, None], mask_full=None,
                           mode="decode", pos=start, impl="kernel")
        else:
            ctx = BlockCtx(positions=start[:, None] + torch.arange(
                c, dtype=start.dtype, device="cuda")[None, :],
                mask_full=None, mode="mixed", pos=start, impl="kernel",
                lengths=sp)
        x = lm._embed(params, cfg, toks)
        flips, near, block_err = 0, 0, 0.0
        for kind, lp, lc in zip(cache_mod.layer_kinds(cfg),
                                params["layers"], cache["layers"]):
            with _Routes() as rk:
                xk, _, _ = blocks.block_apply(
                    kind, lp, cfg, x, ctx,
                    {n: t.clone() for n, t in lc.items()})
            with _Routes() as rr:
                xr, _, _ = blocks.block_apply(
                    kind, lp, cfg, x, ctx._replace(impl="ref"),
                    {n: t.clone() for n, t in lc.items()})
            diff, tie = _route_diff(rk.calls[0], rr.calls[0], k)
            diff, tie = diff.reshape(B, c) & live, tie.reshape(B, c)
            if bool((diff & ~tie).any()):
                fail(f"MoE {name} step: a token routes differently through "
                     f"the kernels where the plain path's top-{k} gap is "
                     f"more than {ROUTE_STEPS} bf16 steps")
            flips += int(diff.sum())
            near += int((tie & live).sum())
            same_rows = ~diff.any(-1)
            rows = live & same_rows[:, None]
            if bool(rows.any()):
                block_err = max(block_err, float(
                    (xk.float() - xr.float()).abs()[rows].max()))
            x = xk
        def run(impl, pin=None):
            with _Routes(pin) as r:
                if name == "decode":
                    lg, _ = lm.decode_step(params, cfg, toks[:, 0],
                                           _clone(cache), start, impl=impl)
                else:
                    lg, _ = lm.mixed_step(params, cfg, toks, _clone(cache),
                                          start, sp, impl=impl)
            return lg, r.calls

        ends = {impl: run(impl) for impl in ("kernel", "ref")}
        differ = torch.zeros((B, c), dtype=torch.bool, device="cuda")
        for ck, cr in zip(ends["kernel"][1], ends["ref"][1]):
            differ |= _route_diff(ck, cr, k)[0].reshape(B, c)
        differ &= live
        rows = live.any(-1) & ~differ.any(-1)
        lk, lr = ends["kernel"][0], ends["ref"][0]
        res = dict(layer_by_layer_flips=flips,
                   layer_by_layer_near_ties=near,
                   max_block_err_same_route_rows=block_err,
                   end_to_end_tokens_routed_differently=int(differ.sum()),
                   end_to_end_share_routed_differently=float(
                       differ.sum() / live.sum()),
                   rows_checked=int(rows.sum()),
                   all_rows_max_abs_err=float(
                       (lk - lr).abs()[live.any(-1)].max()))
        if bool(rows.any()):
            res.update(_compare_logits(lk[rows], lr[rows]))
            if not (np.isfinite(res["max_abs_err"])
                    and res["max_abs_err"] <= LOGITS_ATOL
                    and res["clear_rows_agree"]):
                fail(f"MoE {name} step logits on rows that route the same: "
                     f"{res}")
        lp, _ = run("ref", pin=[i for _, i in ends["kernel"][1]])
        res["pinned"] = _compare_logits(lk[live.any(-1)], lp[live.any(-1)])
        if not (np.isfinite(res["pinned"]["max_abs_err"])
                and res["pinned"]["max_abs_err"] <= LOGITS_ATOL
                and res["pinned"]["clear_rows_agree"]):
            fail(f"MoE {name} step logits, the plain path pinned to the "
                 f"kernel path's experts: {res['pinned']}")
        out[name] = res
    return out


def _moe_step_device(cfg, params) -> dict:
    """Device time of one decode-only step (8 rows at 128 on paged bf16
    latent pools; the dense dispatch) against the floor of reading every
    expert's weights once, and of one MoE FFN alone at that step's shape
    and at a chunk step's (the gather dispatch), times the layers."""
    from repro_torch.models import attention, lm, moe
    m = cfg.moe
    expert_bytes = (cfg.num_layers * (m.num_experts + m.num_shared) * 3
                    * cfg.d_model * m.d_expert * 2)
    cache = lm.init_cache(cfg, B, MAX_LEN, paged=True, page_size=PS,
                          device="cuda")
    cache = lm.set_block_tables(cache, attention.default_block_tables(
        B, MAX_LEN, PS, "cuda"))
    prompt = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, 128)), device="cuda")
    logits, cache = lm.prefill(params, cfg, prompt, cache)
    tok = logits.argmax(-1)
    pos = torch.full((B,), 128, dtype=torch.int32, device="cuda")
    step_us = device_kernel_us(lambda: lm.decode_step(params, cfg, tok,
                                                      cache, pos), iters=5)
    ffn = params["layers"][0]["ffn"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    moe_ms = {}
    for tag, c in (("decode", 1), ("chunk", CHUNK)):
        x = torch.randn((B, c, cfg.d_model), generator=gen,
                        device="cuda").bfloat16()
        moe_ms[tag] = sum(device_kernel_us(lambda x=x: moe.forward(
            ffn, cfg, x), iters=5).values()) / 1e3
    step_ms = sum(step_us.values()) / 1e3
    floor_ms = expert_bytes / HBM_BYTES_PER_S * 1e3
    gemm_ms = sum(us for n, us in step_us.items()
                  if any(w in n.lower() for w in ("gemm", "xmma", "cutlass",
                                                  "nvjet"))) / 1e3
    return dict(decode_step_device_ms=step_ms,
                decode_step_host_ms=host_ms(lambda: lm.decode_step(
                    params, cfg, tok, cache, pos), iters=5),
                expert_weight_bytes=expert_bytes,
                expert_read_floor_ms=floor_ms,
                step_over_floor=step_ms / floor_ms,
                gemm_device_ms=gemm_ms,
                moe_ffn_decode_device_ms_per_layer=moe_ms["decode"],
                moe_ffn_decode_device_ms_all_layers=(moe_ms["decode"]
                                                     * cfg.num_layers),
                moe_ffn_chunk_device_ms_per_layer=moe_ms["chunk"],
                moe_ffn_chunk_device_ms_all_layers=(moe_ms["chunk"]
                                                    * cfg.num_layers),
                kernels=len(step_us))


def _dispatch_split(cfg, widths) -> dict:
    """MoE calls of a run by dispatch: a step of width C runs the dense
    path in every MoE layer when B·C <= E, else the gather path."""
    layers = cfg.num_layers
    dense = sum(1 for c in widths if B * c <= cfg.moe.num_experts) * layers
    total = len(widths) * layers
    return dict(moe_calls=total, dense_calls=dense,
                gather_calls=total - dense,
                dense_share=dense / max(total, 1))


def moe_phase():
    """DeepSeek-V2-Lite at its repo config (``workload.MOE_ARCH``: 27
    ``mla_moe`` layers, 64 routed experts top 6 and 2 shared), seeded
    random bf16 weights: the scheduler on bf16 and on int8 latent pools,
    ``Engine.generate`` on the paged latent cache, the first steps under
    the routing rule, and the device time of a decode step."""
    from repro_torch import configs
    cfg = configs.get(workload.MOE_ARCH)
    params, init_s = _init_params(cfg)
    results = {}
    for quant, kernel, name in (("off", "paged_mla_chunk", "scheduler"),
                                ("int8", "paged_mla_chunk_quant",
                                 "scheduler_int8")):
        widths = []
        eng, reqs, wall, counts = _serve(cfg, params, "kernel",
                                         widths=widths, kv_quant=quant)
        if counts[kernel] <= 0:
            fail(f"the MoE {name} never launched {kernel}")
        _check_answered(cfg, eng, reqs, f"MoE {name}")
        results[name] = dict(_serve_report(eng, wall, counts),
                             **_dispatch_split(cfg, widths))
        del eng
    results["engine_paged"] = _engine_generate(cfg, params, True,
                                               "paged_mla_decode")
    results["first_steps"] = _moe_route_check(cfg, params)
    results["step_device"] = _moe_step_device(cfg, params)
    results["init_s"] = init_s
    results["params"] = sum(t.numel() for t in _leaves(params))
    del params
    return results


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def dense_moe_phase():
    """deepseek-moe-16b (``workload.DENSE_MOE_ARCH``: 28 ``moe`` layers,
    MHA and the MoE FFN), seeded random bf16 weights: the scheduler on
    bf16 pools, which must launch ``paged_chunk_attention``."""
    from repro_torch import configs
    cfg = configs.get(workload.DENSE_MOE_ARCH)
    params, init_s = _init_params(cfg)
    widths = []
    eng, reqs, wall, counts = _serve(cfg, params, "kernel", widths=widths)
    if counts["paged_chunk_attention"] <= 0:
        fail("the deepseek-moe-16b scheduler never launched "
             "paged_chunk_attention")
    _check_answered(cfg, eng, reqs, "deepseek-moe-16b scheduler")
    out = dict(_serve_report(eng, wall, counts),
               **_dispatch_split(cfg, widths), init_s=init_s,
               params=sum(t.numel() for t in _leaves(params)))
    del eng, params
    return {"scheduler": out}


# ---------------------------------------------------------------------------
# xLSTM at full width
# ---------------------------------------------------------------------------

def _states_close(got: dict, want: dict) -> tuple[float, bool]:
    """A recurrent state against another at the bf16 cache tolerance
    (0.0625 + 0.05·|x| an element, PERF.md's parity table)."""
    err, ok = 0.0, True
    for name, w in want.items():
        d = (got[name].float() - w.float()).abs()
        err = max(err, float(d.max()))
        ok &= bool((d <= 0.0625 + 0.05 * w.float().abs()).all())
    return err, ok


def xlstm_phase():
    """xlstm-125m (``workload.XLSTM_ARCH``), seeded random bf16 weights:
    the scheduler (its states reset at admission, no swap tier),
    ``Engine.generate`` on the dense cache, and one 64-token mixed step
    held to 64 decode steps from the same state: every layer's state and
    the last logits at the model tolerance."""
    from repro_torch import configs
    from repro_torch.models import lm
    cfg = configs.get(workload.XLSTM_ARCH)
    params, init_s = _init_params(cfg)
    eng, reqs, wall, counts = _serve(cfg, params, "kernel",
                                     swap_tier_pages=8)
    _check_answered(cfg, eng, reqs, "xLSTM scheduler")
    if eng.swap_pool is not None:
        fail("the xLSTM scheduler built a swap pool")
    results = {"scheduler": _serve_report(eng, wall, counts)}
    del eng
    results["engine_dense"] = _engine_generate(cfg, params, False, None)
    rng = np.random.default_rng(4)
    cache = lm.init_cache(cfg, B, MAX_LEN, device="cuda")
    _, cache = lm.prefill(params, cfg, torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (B, 32)), device="cuda"), cache)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, CHUNK)),
                           device="cuda")
    start = torch.full((B,), 32, dtype=torch.int32, device="cuda")
    lm_mixed, mixed = lm.mixed_step(params, cfg, toks, _clone(cache), start,
                                    torch.full_like(start, CHUNK))
    stepped = _clone(cache)
    for i in range(CHUNK):
        lm_dec, stepped = lm.decode_step(params, cfg, toks[:, i], stepped,
                                         start + i)
    errs, ok = [], True
    for lw, lt in zip(stepped["layers"], mixed["layers"]):
        e, good = _states_close(lt, lw)
        errs.append(e)
        ok &= good
    res = dict(_compare_logits(lm_mixed, lm_dec),
               state_max_abs_err_per_layer=errs, states_close=ok)
    if not (ok and res["max_abs_err"] <= LOGITS_ATOL
            and res["clear_rows_agree"]):
        fail(f"xLSTM mixed step against {CHUNK} decode steps: {res}")
    results["mixed_vs_decode"] = res
    results["init_s"] = init_s
    return results


# ---------------------------------------------------------------------------
# Training: OLMo-1B at full width through make_train_step, the reduced
# card-against-CPU steps, the checkpoint round trip, the elastic launcher
# ---------------------------------------------------------------------------

TRAIN_ARCH = "olmo-1b"
TRAIN_DATA = dict(seq_len=128, batch_size=8)      # JAX's launcher's shape
TRAIN_TIMED = 4                       # timed steps after the warm-up step
# AdamW's floor a parameter: the bf16 grad and parameter read, the two
# float32 moments read and written, the parameter written.
ADAMW_BYTES_PER_PARAM = 2 + 2 + 8 + 8 + 2
# remat recomputes the same bf16 ops: each grad leaf within one bf16 step
# of its largest |g| (the recomputed forward may reorder no sum, but the
# backward's accumulations over layers can).
REMAT_RTOL = 2 ** -7
# The reduced card-against-CPU step, float32 weights, TF32 off: the loss,
# grad norm and metrics within 1e-5 relative; each grad leaf within 1e-4
# of its largest |g| plus 1e-7 (a leaf whose exact gradient is 0 carries
# noise alone); new parameters within 1e-6 + 1e-6·|p|, or 2·lr + 1e-6 where
# the gradient sits in that noise band (AdamW's first step moves an
# element by about lr·sign(g), and a noise-level g may flip its sign).
PARITY_RTOL, GRAD_RTOL, GRAD_FLOOR = 1e-5, 1e-4, 1e-7
PARITY_LR = 1e-3


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``a`` and ``b`` hold the same dtype, shape and bytes."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(_bits(a.detach().reshape(-1)),
                            _bits(b.detach().reshape(-1))))


def _leaf_share(got, want) -> float:
    """The largest |got - want| of any leaf as a share of that leaf's
    largest |want|."""
    return max(float((a.float() - b.float()).abs().max())
               / max(float(b.float().abs().max()), 1e-30)
               for a, b in zip(got, want))


def _grad_guard_check() -> dict:
    """A loss on ``impl="kernel"`` raises on the card in the first kernel
    wrapper the forward reaches (whisper's encoder: ``flash_attention``;
    an RG-LRU layer: ``linear_scan``); the same forward runs under
    ``torch.no_grad()``, and the plain path gives every leaf a grad."""
    from repro_torch import configs
    from repro_torch.core import tree
    from repro_torch.models import lm
    out = {}
    for arch, kernel in (("whisper-tiny", "flash_attention"),
                         ("recurrentgemma-2b", "linear_scan")):
        cfg = configs.reduced(configs.get(arch))
        params = lm.init(cfg, seed=0, device="cuda")
        leaves = [p.requires_grad_() for p in tree.leaves(params)]
        gen = torch.Generator("cuda").manual_seed(0)
        toks = torch.randint(0, cfg.vocab_size, (2, 16), device="cuda",
                             generator=gen)
        frames = (torch.randn((2, cfg.encoder.seq_len, cfg.d_model),
                              device="cuda", generator=gen).bfloat16()
                  if cfg.is_encdec else None)
        try:
            lm.forward(params, cfg, toks, enc_frames=frames, impl="kernel")
        except RuntimeError as e:
            if kernel not in str(e) or "no backward" not in str(e):
                fail(f"{arch}: the guard raised the wrong error: {e}")
        else:
            fail(f"{arch}: forward(impl='kernel') under grad did not raise")
        with torch.no_grad():
            lm.forward(params, cfg, toks, enc_frames=frames, impl="kernel")
        batch = {"tokens": toks, "targets": toks,
                 "loss_mask": torch.ones(toks.shape, device="cuda")}
        if frames is not None:
            batch["enc_frames"] = frames
        loss, _ = lm.loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, leaves)
        out[arch] = {"raised_in": kernel, "plain_grad_leaves": len(grads)}
    return out


def train_phase() -> tuple[dict, object]:
    """OLMo-1B at full width (seeded bf16 weights) through
    ``make_train_step`` on one repeated batch of JAX's launcher's shape:
    a warm-up step (every leaf gets a finite grad and changes; remat gives
    the same loss and grads), TRAIN_TIMED timed steps (the loss falls), and
    the step split into forward + backward and the optimizer.  Returns the
    report and the trainer, whose state the checkpoint phase saves."""
    import tempfile
    from repro_torch import configs
    from repro_torch.core import tree
    from repro_torch.data.pipeline import DataConfig, shard_batches
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_step import make_train_step, to_device
    from repro_torch.training.trainer import Trainer, TrainerConfig

    cfg = configs.get(TRAIN_ARCH)
    dc = DataConfig(vocab_size=cfg.vocab_size, **TRAIN_DATA)
    tokens = dc.seq_len * dc.batch_size
    n_params = cfg.param_count()
    opt = AdamW(warmup=2, total_steps=TRAIN_TIMED + 2)
    tcfg = TrainerConfig(steps=TRAIN_TIMED + 1, keep=1,
                         checkpoint_dir=tempfile.mkdtemp(
                             prefix="chip_smoke_ckpt_"))
    t0 = time.perf_counter()
    trainer = Trainer(cfg, dc, tcfg, opt=opt, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params, state = trainer.params, trainer.opt_state
    leaves = tree.leaves(params)
    batch = to_device(shard_batches(dc, 0)[0], "cuda")
    step = make_train_step(cfg, opt, remat=False)
    ops.reset_launch_counts()

    def fwd_bwd(remat=False):
        loss, _ = lm.loss_fn(params, cfg, batch, remat=remat)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    loss0, grads = fwd_bwd()
    if not all(bool(torch.isfinite(g).all()) for g in grads):
        fail("train: a gradient leaf is not finite")
    loss_r, grads_r = fwd_bwd(remat=True)
    remat_share = _leaf_share(grads_r, grads)
    if float(loss_r) != float(loss0) or remat_share > REMAT_RTOL:
        fail(f"train: remat changed the step: loss {float(loss_r)} vs "
             f"{float(loss0)}, grads {remat_share:.3g} of a leaf's max")
    del grads_r
    before = [p.detach().clone() for p in leaves]
    params, state, m = step(params, state, batch)
    unchanged = [i for i, (a, p) in enumerate(zip(before, leaves))
                 if _same_bits(a, p)]
    del before
    if unchanged:
        fail(f"train: leaves {unchanged} did not change after a step")

    torch.cuda.reset_peak_memory_stats()
    losses, norms, step_ms = [float(m["loss"])], [float(m["grad_norm"])], []
    for _ in range(TRAIN_TIMED):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))        # waits for the step
        step_ms.append((time.perf_counter() - t) * 1e3)
        norms.append(float(m["grad_norm"]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not np.all(np.isfinite(losses + norms)):
        fail(f"train: losses {losses}, grad norms {norms}")
    if not losses[-1] < losses[0]:
        fail(f"train: the loss did not fall on a repeated batch: {losses}")

    def opt_step():
        opt.update(grads, state, params)

    split = {
        "fwd_bwd_ms": cuda_ms(fwd_bwd, iters=3, warmup=1),
        "fwd_bwd_wall_ms": host_ms(fwd_bwd, iters=3),
        "fwd_bwd_device_ms": sum(device_kernel_us(fwd_bwd, 2).values())
        / 1e3,
        "opt_ms": cuda_ms(opt_step, iters=3, warmup=1),
        "opt_wall_ms": host_ms(opt_step, iters=3),
        "opt_device_ms": sum(device_kernel_us(opt_step, 2).values()) / 1e3,
    }
    launches = ops.launch_counts()
    if sum(launches.values()):
        fail(f"train: the plain training path launched kernels {launches}")
    step_s = float(np.median(step_ms)) / 1e3
    opt_floor_ms = ADAMW_BYTES_PER_PARAM * n_params / HBM_BYTES_PER_S * 1e3
    trainer.params, trainer.opt_state = params, state
    trainer.step = TRAIN_TIMED + 1
    return {"arch": TRAIN_ARCH, "params": n_params, "leaves": len(leaves),
            "tokens_a_step": tokens, "init_s": init_s,
            "losses": losses, "grad_norms": norms, "step_ms": step_ms,
            "step_ms_median": step_s * 1e3,
            "tokens_per_s": tokens / step_s, "peak_gb": peak_gb,
            "model_flop_share": 6 * n_params * tokens / step_s
            / BF16_FLOPS_PER_S,
            **split, "opt_floor_ms": opt_floor_ms,
            "opt_share_of_floor": opt_floor_ms / split["opt_device_ms"],
            "remat_loss_equal": True, "remat_grad_share": remat_share,
            "every_leaf_changed": True, "launches": launches,
            "guard": _grad_guard_check()}, trainer


def train_device_parity(arch: str) -> dict:
    """One ``make_train_step`` of a reduced ``arch`` with float32 weights
    on the card and on the CPU from the same tree and batch, held to the
    PARITY rules: loss, grad norm, every grad leaf, the new parameters."""
    from repro_torch import configs
    from repro_torch.core import tree
    from repro_torch.data.pipeline import DataConfig, shard_batches
    from repro_torch.models import lm
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_step import make_train_step, to_device

    cfg = configs.reduced(configs.get(arch), d_model=64, vocab=256)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, batch_size=4)
    batch = shard_batches(dc, 1)[0]
    opt = AdamW(lr_peak=PARITY_LR, warmup=1, total_steps=4)
    cpu = tree.map(lambda t: t.float(), lm.init(cfg, seed=0, device="cpu"))
    got = {}
    for dev in ("cpu", "cuda"):
        params = tree.map(lambda t: t.to(dev, copy=True), cpu)
        leaves = [p.requires_grad_() for p in tree.leaves(params)]
        loss, _ = lm.loss_fn(params, cfg, to_device(batch, dev))
        grads = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
        params, _, m = make_train_step(cfg, opt, remat=False)(
            params, opt.init(params), batch)
        got[dev] = (float(loss.detach()), grads, {k: float(v) for k, v in m.items()},
                    [p.detach().cpu() for p in tree.leaves(params)])
    (l_c, g_c, m_c, p_c), (l_g, g_g, m_g, p_g) = got["cpu"], got["cuda"]
    rel = {k: abs(m_g[k] / m_c[k] - 1) for k in ("loss", "grad_norm", "xent")}
    rel["loss_fn"] = abs(l_g / l_c - 1)
    if max(rel.values()) > PARITY_RTOL:
        fail(f"train parity {arch}: {rel}")
    grad_share, flips, param_err = 0.0, 0, 0.0
    for gc_, gg, pc, pg in zip(g_c, g_g, p_c, p_g):
        scale = float(gc_.abs().max())
        err = float((gg - gc_).abs().max())
        if err > GRAD_RTOL * scale + GRAD_FLOOR:
            fail(f"train parity {arch}: a grad leaf {tuple(gc_.shape)} "
                 f"off by {err:.3g} (max |g| {scale:.3g})")
        grad_share = max(grad_share, err / max(scale, GRAD_FLOOR / GRAD_RTOL))
        noise = gc_.abs() <= GRAD_RTOL * scale + GRAD_FLOOR
        d = (pg - pc).abs()
        tight = d <= 1e-6 + 1e-6 * pc.abs()
        loose = d <= 2 * PARITY_LR + 1e-6
        if not bool((tight | (noise & loose)).all()):
            fail(f"train parity {arch}: new parameters off by "
                 f"{float(d.max()):.3g}")
        flips += int((~tight).sum())
        param_err = max(param_err, float(d[~noise].max()) if
                        bool((~noise).any()) else 0.0)
    return {"loss_cpu": l_c, "loss_cuda": l_g, "rel": rel,
            "grad_share": grad_share, "param_err": param_err,
            "noise_flips": flips}


def checkpoint_phase(trainer) -> dict:
    """``Trainer.save`` of the full-width params and AdamW state, restored
    into a fresh ``Trainer`` (other seed): every leaf bitwise, the step
    too.  The directory is removed afterwards."""
    import shutil
    from repro_torch.core import tree
    from repro_torch.training.trainer import Trainer
    ckpt_dir = trainer.tcfg.checkpoint_dir
    state = {"params": trainer.params, "opt": trainer.opt_state}
    nbytes = sum(t.numel() * t.element_size() for t in tree.leaves(state))
    free = shutil.disk_usage(ckpt_dir).free
    try:
        if free < 1.1 * nbytes:
            fail(f"checkpoint: {free / 1e9:.1f} GB free under {ckpt_dir}, "
                 f"{nbytes / 1e9:.1f} GB needed at full width")
        t = time.perf_counter()
        trainer.save()
        trainer.ckpt.wait()
        save_s = time.perf_counter() - t
        fresh = Trainer(trainer.cfg, trainer.data_cfg, trainer.tcfg,
                        opt=trainer.opt, seed=1, device="cuda")
        t = time.perf_counter()
        if not fresh.maybe_restore():
            fail("checkpoint: nothing to restore")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        want = tree.leaves(state)
        got = tree.leaves({"params": fresh.params, "opt": fresh.opt_state})
        bad = [i for i, (a, b) in enumerate(zip(got, want))
               if a.device != b.device or not _same_bits(a, b)]
        if bad or len(got) != len(want) or fresh.step != trainer.step:
            fail(f"checkpoint: leaves {bad} did not come back bitwise "
                 f"(step {fresh.step} vs {trainer.step})")
        del fresh, got
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"bytes": nbytes, "leaves": len(want), "save_s": save_s,
            "restore_s": restore_s, "free_bytes": free,
            "save_gb_per_s": nbytes / save_s / 1e9,
            "restore_gb_per_s": nbytes / restore_s / 1e9}


ELASTIC_CMD = ["-m", "repro_torch.launch.train", "--arch", "olmo-1b",
               "--steps", "8", "--workers", "2", "--fail-worker1-at", "3",
               "--seq-len", "32", "--batch", "2"]


def elastic_phase() -> dict:
    """JAX's launcher test on the card: worker 1 crashes after 3 steps,
    worker 2 reclaims its shard and finishes at step 8."""
    import shutil
    import tempfile
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    try:
        out = subprocess.run(
            [sys.executable, *ELASTIC_CMD, "--ckpt-dir", ckpt],
            env={**os.environ, "PYTHONPATH": os.path.join(HERE, "src")},
            capture_output=True, text=True, timeout=300)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    lines = out.stdout.splitlines()
    if out.returncode != 0 or not any(
            ln.startswith("worker1: crashed=True") for ln in lines) or not \
            any(ln.startswith("worker2: crashed=False step=8")
                for ln in lines):
        fail(f"elastic launcher: rc {out.returncode}\n{out.stdout[-2000:]}"
             f"\n{out.stderr[-2000:]}")
    return {"lines": [ln for ln in lines if ln.startswith("worker")]}


def training_phases(card: str) -> dict:
    """The four training phases in turn, each reported with its seconds."""
    report = {}
    t = time.perf_counter()
    train, trainer = train_phase()
    train["phase_s"] = time.perf_counter() - t
    emit({"train": train, "card": card})
    report["train"] = train
    t = time.perf_counter()
    ckpt = checkpoint_phase(trainer)
    ckpt["phase_s"] = time.perf_counter() - t
    emit({"train_checkpoint": ckpt, "card": card})
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    parity = {arch: train_device_parity(arch)
              for arch in ("olmo-1b", "recurrentgemma-2b")}
    parity["phase_s"] = time.perf_counter() - t
    emit({"train_card_cpu": parity, "card": card})
    t = time.perf_counter()
    elastic = elastic_phase()
    elastic["phase_s"] = time.perf_counter() - t
    emit({"train_elastic": elastic, "card": card})
    report.update(checkpoint=ckpt, card_cpu=parity, elastic=elastic)
    report["phases_s"] = sum(r["phase_s"] for r in
                             (train, ckpt, parity, elastic))
    return report


# ---------------------------------------------------------------------------
# The fused decode + coordination step (phase fused_coord)
# ---------------------------------------------------------------------------

FUSED = dict(rows=8, replicas=4, prompt_len=128, max_len=1024, page_size=16,
             steps=32, nccl_steps=8, delta_capacity=64)
FUSED_INACTIVE_ROW = 7              # one row keeps its token throughout
FUSED_KERNEL = {False: "decode_attention", True: "paged_decode_attention"}


def _fused_setup(cfg, params, paged, impl, rows, prompt_len, max_len,
                 page_size):
    """(cache, first token, pos, prompt) after prefilling ``rows`` seeded
    prompts: the decode rows the fused step starts from."""
    from repro_torch.models import attention, lm
    dev = params["embed"]["w"].device
    prompt = torch.as_tensor(np.random.default_rng(28).integers(
        0, cfg.vocab_size, (rows, prompt_len)), device=dev)
    cache = lm.init_cache(cfg, rows, max_len, paged=paged,
                          page_size=page_size, device=dev)
    if paged:
        cache = lm.set_block_tables(cache, attention.default_block_tables(
            rows, max_len, page_size, dev))
    logits, cache = lm.prefill(params, cfg, prompt, cache, impl=impl)
    token = torch.argmax(logits, dim=-1).to(torch.int32)
    pos = torch.full((rows,), prompt_len, dtype=torch.int32, device=dev)
    return cache, token, pos, prompt


def fused_coord_run(cfg, params, mesh, strategy, merge_every, *, paged,
                    impl="kernel", steps=None, check=True, **kw) -> dict:
    """``engine.make_fused_serve_step`` for ``steps`` steps on the rows of
    ``FUSED`` (overrides in ``kw``), one slot a row, from a prefilled
    prompt.  With ``check`` (a ``StackedMesh``), after every merge: all
    replicas' doc digests equal, the merged doc bitwise the fold join of
    the replicas' own appends, and the delta frontier that join's
    frontier.  Returns the generated streams (the prefill's token first),
    the coord, the launch counts of the steps alone and their
    synchronized wall ms."""
    from repro_torch.core import delta as delta_mod
    from repro_torch.core import doc as doc_mod
    from repro_torch.core import gset
    from repro_torch.core import merge as merge_mod
    from repro_torch.kernels import ops
    from repro_torch.sharding import mesh as mesh_mod
    from repro_torch.serving import engine
    f = dict(FUSED, **kw)
    steps = f["steps"] if steps is None else steps
    rows = f["rows"]
    dev = params["embed"]["w"].device
    r = mesh_mod.local_replicas(mesh, ("data",))
    cache, token, pos, prompt = _fused_setup(
        cfg, params, paged, impl, rows, f["prompt_len"], f["max_len"],
        f["page_size"])
    slots = torch.arange(rows, dtype=torch.int32, device=dev)
    active = torch.ones(rows, dtype=torch.bool, device=dev)
    if rows > FUSED_INACTIVE_ROW:
        active[FUSED_INACTIVE_ROW] = False
    doc0 = doc_mod.empty(rows, steps, device=dev)
    coord = {"doc": doc0,
             "heartbeats": gset.GCounter.zeros(r, device=dev)}
    if strategy == "delta":
        coord = engine.with_delta_frontier(coord)
    coord = engine.replicate_coord(coord, r)
    own = [doc0] * r                # each replica's own appends, unmerged
    step_fn = engine.make_fused_serve_step(
        cfg, mesh, ("data",), impl=impl, merge_strategy=strategy,
        merge_every=merge_every, delta_capacity=f["delta_capacity"])
    stream, wall, checked = [token], [], 0
    per = rows // r
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for t in range(steps):
        t0 = time.perf_counter()
        token, cache, pos, coord = step_fn(params, cache, token, pos, slots,
                                           active, coord, t)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        stream.append(token)
        if not check:
            continue
        for i in range(r):
            sl = slice(i * per, (i + 1) * per)
            own[i] = doc_mod.append_token_batch(own[i], slots[sl],
                                                token[sl], active[sl])
        if t % merge_every == 0:
            want = merge_mod.fold_join(own)
            digests = {int(doc_mod.digest(merge_mod.tree.map(
                lambda x: x[i], coord["doc"]))) for i in range(r)}
            if len(digests) != 1:
                fail(f"fused {strategy}/{merge_every}: replicas' digests "
                     f"differ after step {t}: {digests}")
            for i in range(r):
                got = merge_mod.tree.map(lambda x: x[i], coord["doc"])
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    fail(f"fused {strategy}/{merge_every}: replica {i}'s "
                         f"doc is not the fold join at step {t}")
                if strategy == "delta" and not torch.equal(
                        coord["frontier"]["doc"].length[i],
                        delta_mod.frontier(want).length):
                    fail(f"fused delta/{merge_every}: frontier behind the "
                         f"join at step {t}")
            checked += 1
    counts = ops.launch_counts()
    return dict(stream=torch.stack(stream, 1).cpu().numpy(), coord=coord,
                prompt=prompt.cpu().numpy(), launches=counts,
                step_ms=float(np.median(wall)), step_ms_max=max(wall),
                merges_checked=checked, merge_fn=engine.make_coord_merge(
                    mesh, ("data",), strategy,
                    delta_capacity=f["delta_capacity"]))


def _fused_streams_tie_aware(cfg, params, a, b, label) -> dict:
    """Row by row, two fused runs' streams are equal, or their first
    difference falls where the plain path's top-2 gap is at most twice the
    logit tolerance."""
    differing, gaps = 0, []
    for row, (sa, sb) in enumerate(zip(a["stream"], b["stream"])):
        diff = np.nonzero(sa != sb)[0]
        if not diff.size:
            continue
        differing += 1
        j = int(diff[0])
        gap = _stream_gap(cfg, params, a["prompt"][row], sa, j)
        gaps.append(gap)
        if gap > 2 * LOGITS_ATOL:
            fail(f"fused streams ({label}): row {row} differs at {j} where "
                 f"the top-2 gap is {gap}")
    return dict(rows_differing=differing, gaps=gaps)


def _merge_ms(run, iters: int = 10) -> float:
    """Synchronized wall ms of one merge of the run's final coord."""
    coord = run["coord"]
    run["merge_fn"](coord)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        run["merge_fn"](coord)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _wire_bytes(strategy, run, r, capacity) -> int:
    """Bytes on the wire for one sync of ``r`` replicas: JAX's model
    (``delta.full_state_wire_bytes``) for the full-state strategies; for
    the delta ring the shipped buffers' ``nbytes`` over r·(r-1) hops."""
    from repro_torch.core import delta as delta_mod
    from repro_torch.core import tree
    state = {k: tree.map(lambda x: x[0], v)
             for k, v in run["coord"].items() if k != "frontier"}
    if strategy != "delta":
        return delta_mod.full_state_wire_bytes(strategy, r,
                                               delta_mod.nbytes(state))
    fr = tree.map(lambda x: x[0], run["coord"]["frontier"])
    d, _ = delta_mod.extract(state, fr, capacity)
    return r * (r - 1) * delta_mod.nbytes(d)


def fused_nccl_check(cfg, params, strategies=("pmax", "allgather", "delta"),
                     **kw) -> dict:
    """The process-group route on the card: a one-rank NCCL group (file
    store), a (1, 1) ``DeviceMesh``, the fused step per strategy; tokens
    and coord bitwise those of the stacked route at R = 1.  The group is
    destroyed whatever happens."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import tree
    from repro_torch.sharding.mesh import StackedMesh
    torch.cuda.set_device(params["embed"]["w"].device)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method=f"file://{d}/pg",
                                rank=0, world_size=1)
        try:
            mesh = init_device_mesh("cuda", (1, 1),
                                    mesh_dim_names=("data", "model"))
            for s in strategies:
                runs = [fused_coord_run(cfg, params, m, s, 1, paged=False,
                                        check=False, **kw)
                        for m in (mesh, StackedMesh((1, 1),
                                                    ("data", "model")))]
                same_tokens = np.array_equal(runs[0]["stream"],
                                             runs[1]["stream"])
                same_coord = all(torch.equal(a, b) for a, b in zip(
                    tree.leaves(runs[0]["coord"]),
                    tree.leaves(runs[1]["coord"])))
                if not (same_tokens and same_coord):
                    fail(f"NCCL route {s}: tokens equal {same_tokens}, "
                         f"coord equal {same_coord} against R = 1 stacked")
                out[s] = dict(steps=runs[0]["stream"].shape[1] - 1,
                              step_ms=runs[0]["step_ms"],
                              launches=runs[0]["launches"],
                              merge_ms=_merge_ms(runs[0]))
        finally:
            dist.destroy_process_group()
    return out


def fused_coord_phase(cfg, params, card) -> dict:
    """OLMo-1B at full width through the fused decode + coordination step:
    R = 4 replicas stacked on the card (2 rows each), the pmax, allgather
    and delta strategies, ``merge_every`` 1 and 4, a dense cache
    (``decode_attention``) and pages of 16 (``paged_decode_attention``),
    through the kernels, and once a cache through the plain versions
    (streams tie-aware, no kernel launched); then the one-rank NCCL route
    against R = 1."""
    from repro_torch.sharding.mesh import StackedMesh
    t0 = time.perf_counter()
    mesh = StackedMesh((FUSED["replicas"], 1), ("data", "model"))
    out = {}
    for paged in (False, True):
        label = "paged" if paged else "dense"
        kernel = FUSED_KERNEL[paged]
        ref = fused_coord_run(cfg, params, mesh, "pmax", 1, paged=paged,
                              impl="ref")
        if sum(ref["launches"].values()):
            fail(f"fused {label} ref run launched {ref['launches']}")
        runs = {}
        for strategy in ("pmax", "allgather", "delta"):
            for every in (1, 4):
                run = fused_coord_run(cfg, params, mesh, strategy, every,
                                      paged=paged)
                if run["launches"][kernel] <= 0:
                    fail(f"fused {label} {strategy}/{every} never launched "
                         f"{kernel}")
                ties = _fused_streams_tie_aware(cfg, params, run, ref,
                                                f"{label} {strategy}")
                runs[f"{strategy}/{every}"] = dict(
                    step_ms=run["step_ms"], step_ms_max=run["step_ms_max"],
                    merge_ms=_merge_ms(run), launches=run["launches"],
                    merges_checked=run["merges_checked"],
                    wire_bytes_per_sync=_wire_bytes(
                        strategy, run, FUSED["replicas"],
                        FUSED["delta_capacity"]),
                    ref_agree_share=_agree_share(run["stream"],
                                                 ref["stream"]),
                    ref_ties=ties)
                del run
        out[label] = dict(runs=runs, ref=dict(step_ms=ref["step_ms"],
                                               launches=ref["launches"]),
                          fused_launches=runs["pmax/1"]["launches"][kernel])
        emit({"fused_coord": label, **{k: {kk: vv for kk, vv in v.items()
                                           if kk != "launches"}
                                       for k, v in runs.items()},
              "card": card})
    out["nccl"] = fused_nccl_check(cfg, params, steps=FUSED["nccl_steps"])
    out["phase_s"] = time.perf_counter() - t0
    emit({"fused_coord_nccl": {k: {kk: vv for kk, vv in v.items()
                                   if kk != "launches"}
                               for k, v in out["nccl"].items()},
          "fused_coord_phase_s": out["phase_s"], "card": card})
    return out


SHARDED = dict(rows=8, prompt_len=128, max_len=256, page_size=16, steps=8)
# (arch, variant, flags) of the dry-run records, each decode_32k on the
# single mesh.
DRYRUN_CELLS = (
    ("olmo-1b", "baseline", []),
    ("olmo-1b", "fused_delta", ["--fused-coord", "--merge-strategy",
                                "delta"]),
    (workload.XLSTM_ARCH, "baseline", []))


def _dryrun_records() -> dict:
    """The dry run of olmo-1b x decode_32k on the single mesh, plain and
    with the fused delta step, and of xlstm-125m x decode_32k (its cells
    use ``activation.einsum``), each in its own process (the fake group of
    256 ranks is that process's default group): every record must carry
    collective bytes with a positive total."""
    from repro_torch.launch import dryrun
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    procs = {(arch, v): subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         arch, "--shape", "decode_32k", "--mesh", "single", "--force",
         "--variant", v, *flags], cwd=HERE, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for arch, v, flags in DRYRUN_CELLS}
    out = {}
    for (arch, v), p in procs.items():
        _, err = p.communicate(timeout=300)
        path = dryrun.OUT_DIR / "single" / f"{arch}__decode_32k__{v}.json"
        rec = json.loads(path.read_text()) if path.exists() else {}
        coll = rec.get("collective_bytes_per_device") or {}
        if p.returncode or rec.get("status") != "ok" or not (
                coll.get("total", 0) > 0):
            fail(f"dry run {arch} {v}: rc {p.returncode}, status "
                 f"{rec.get('status')}, collectives {coll}: {err[-2000:]}")
        out[f"{arch}/{v}"] = {"count_s": rec["count_s"],
                  "flops_per_device": rec["flops_per_device"],
                  "bytes_per_device": rec["bytes_per_device"],
                  "collective_bytes_per_device": coll}
    return out


def _refuses(fn) -> bool:
    from repro_torch.kernels import ops
    try:
        fn()
    except ops.ShardedKernelError:
        return True
    return False


def _sharded_serve(cfg, params, sp, rows, paged: bool,
                   label: str = "") -> dict:
    """Prefill SHARDED rows and decode SHARDED["steps"] tokens on plain
    tensors and on the ``DTensor`` model (``impl="ref"``, the plain path
    a sharded run takes), the plain run's tokens fed to both: logits each
    step and the final cache bitwise."""
    from repro_torch.core import tree
    from repro_torch.models import attention, lm
    from repro_torch.sharding import activation, partition
    sh = SHARDED
    dev = params["embed"]["w"].device
    prompt = torch.as_tensor(np.random.default_rng(30).integers(
        0, cfg.vocab_size, (sh["rows"], sh["prompt_len"])), device=dev)
    cache = lm.init_cache(cfg, sh["rows"], sh["max_len"], paged=paged,
                          page_size=sh["page_size"], device=dev)
    if paged:
        cache = lm.set_block_tables(cache, attention.default_block_tables(
            sh["rows"], sh["max_len"], sh["page_size"], dev))
    part = partition.Partitioner(rows.mesh, fsdp=False)
    sc = partition.shard_cache(tree.map(torch.clone, cache), part)
    def bind():
        return activation.bind(activation.standard_binding(("data",)))

    times = {}
    with torch.no_grad():
        t = time.perf_counter()
        logits, cache = lm.prefill(params, cfg, prompt, cache, impl="ref")
        torch.cuda.synchronize()
        times["plain_prefill_ms"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        with bind():
            sl, sc = lm.prefill(sp, cfg, rows(prompt), sc, impl="ref")
        torch.cuda.synchronize()
        times["sharded_prefill_ms"] = (time.perf_counter() - t) * 1e3
        equal = [torch.equal(logits, sl.full_tensor())]
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        pos = torch.full((sh["rows"],), sh["prompt_len"], dtype=torch.int32,
                         device=dev)
        plain_ms, sharded_ms = [], []
        for _ in range(sh["steps"]):
            t = time.perf_counter()
            logits, cache = lm.decode_step(params, cfg, token, cache, pos,
                                           impl="ref")
            torch.cuda.synchronize()
            plain_ms.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            with bind():
                sl, sc = lm.decode_step(sp, cfg, rows(token), sc, rows(pos),
                                        impl="ref")
            torch.cuda.synchronize()
            sharded_ms.append((time.perf_counter() - t) * 1e3)
            equal.append(torch.equal(logits, sl.full_tensor()))
            token = torch.argmax(logits, dim=-1).to(torch.int32)
            pos = pos + 1
        cache_equal = all(torch.equal(a, b) for a, b in zip(
            tree.leaves(cache), tree.leaves(partition.full_tensor(sc))))
    label = f"{label} {'paged' if paged else 'dense'}"
    if not (all(equal) and cache_equal):
        fail(f"sharded {label}: logits equal a step {equal}, cache equal "
             f"{cache_equal}")
    return {**times, "plain_decode_ms": float(np.median(plain_ms)),
            "sharded_decode_ms": float(np.median(sharded_ms)),
            "steps": sh["steps"], "bitwise": True}


def _sharded_train(cfg, params, mesh, rows) -> dict:
    """One FSDP train step of the training phase's shape on ``DTensor``
    leaves against the same step on plain tensors: loss, grad norm, the
    new parameters and moments bitwise."""
    from repro_torch.core import tree
    from repro_torch.data.pipeline import DataConfig, shard_batches
    from repro_torch.sharding import activation, partition
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_step import make_train_step, to_device
    dc = DataConfig(vocab_size=cfg.vocab_size, **TRAIN_DATA)
    batch = to_device(shard_batches(dc, 0)[0], params["embed"]["w"].device)
    opt = AdamW(warmup=2, total_steps=4)
    step = make_train_step(cfg, opt)
    part = partition.Partitioner(mesh, fsdp=True)
    plain = tree.map(lambda x: x.detach().clone(), params)
    state = opt.init(plain)
    sp = partition.shard_params(tree.map(lambda x: x.detach().clone(),
                                         params), part)
    sst = partition.shard_opt_state(opt.init(params), params, part)
    t = time.perf_counter()
    plain, state, m = step(plain, state, batch)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    with activation.bind(activation.standard_binding(("data",))):
        sp, sst, sm = step(sp, sst, {k: rows(v) for k, v in batch.items()})
    torch.cuda.synchronize()
    sharded_ms = (time.perf_counter() - t) * 1e3
    full = partition.full_tensor
    checks = {
        "loss": torch.equal(m["loss"], full(sm["loss"])),
        "grad_norm": torch.equal(m["grad_norm"], full(sm["grad_norm"])),
        "params": all(torch.equal(a.detach(), b.detach()) for a, b in zip(
            tree.leaves(plain), tree.leaves(full(sp)))),
        "moments": all(torch.equal(a, b) for a, b in zip(
            tree.leaves([state.mu, state.nu]),
            tree.leaves(full([sst.mu, sst.nu]))))}
    if not all(checks.values()):
        fail(f"sharded train step: bitwise {checks}")
    return {"plain_ms": plain_ms, "sharded_ms": sharded_ms,
            "loss": float(m["loss"]), "bitwise": checks}


def _dsv2_two_layers():
    """DeepSeek-V2-Lite at full width with its depth cut to 2 layers: its
    dense first layer (MLA and the dense FFN of 10,944, as the published
    model's layer 0; ``workload.mla_config``'s) and one MLA + MoE layer as
    configured (64 routed experts, top 6, 2 shared)."""
    from repro_torch import configs
    return configs.get(workload.MOE_ARCH).replace(
        name="deepseek-v2-lite-16b-2l", num_layers=2,
        block_pattern=("mla", "mla_moe"), d_ff=workload.MLA_DENSE_FFN)


def _sharded_families(rows) -> dict:
    """The sharded serve check of ``_sharded_serve`` on two more families,
    seeded random bf16 weights at full width: xlstm-125m at full depth
    (12 layers; prefill and dense decode on its recurrent states, whose
    cells contract through ``activation.einsum``) and DeepSeek-V2-Lite cut
    to 2 layers (prefill into bf16 latent pages and paged decode; its
    latent rows through ``activation.last_whole``)."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.sharding import partition
    dev = rows.mesh.device_type
    out = {}
    for name, cfg, paged, depth in (
            ("xlstm", configs.get(workload.XLSTM_ARCH), False,
             "full depth"),
            ("dsv2", _dsv2_two_layers(), True,
             "depth cut to 2 layers: the dense first layer and one MoE "
             "layer")):
        t = time.perf_counter()
        params = lm.init(cfg, seed=0, device=dev)
        sp = partition.shard_params(
            params, partition.Partitioner(rows.mesh, fsdp=False))
        res = _sharded_serve(cfg, params, sp, rows, paged, label=name)
        out[name] = dict(res, arch=cfg.name, layers=cfg.num_layers,
                         depth=depth, phase_s=time.perf_counter() - t)
        del params, sp
        gc.collect()
        if dev == "cuda":
            torch.cuda.empty_cache()
    return out


def sharded_phase(cfg, params, card) -> dict:
    """OLMo-1B at full width on ``DTensor`` parameters: a one-rank NCCL
    group (file store) and a (1, 1) ("data", "model") ``DeviceMesh``, the
    partitioner's placements (tensor-parallel for serving, FSDP for
    training); the prefill of 8 x 128 tokens with 8 dense and 8 paged
    decode steps, and one train step of the training phase's shape, each
    bitwise the same call on plain tensors (one rank runs the same local
    ops); the kernel wrappers refuse a ``DTensor`` under
    ``impl="kernel"``; the same serve check on xlstm-125m and on
    DeepSeek-V2-Lite cut to 2 layers (``_sharded_families``); then the dry
    run's three records."""
    import functools
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels import ops
    from repro_torch.sharding import partition
    t0 = time.perf_counter()
    dev = params["embed"]["w"].device
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"file://{d}/pg", rank=0,
                                world_size=1)
        try:
            mesh = init_device_mesh(dev.type, (1, 1),
                                    mesh_dim_names=("data", "model"))
            rows = functools.partial(partition.shard_batch, mesh=mesh,
                                     dp_axes=("data",))
            rows.mesh = mesh
            sp = partition.shard_params(
                params, partition.Partitioner(mesh, fsdp=False))
            for paged in (False, True):
                out["paged" if paged else "dense"] = _sharded_serve(
                    cfg, params, sp, rows, paged)
            q = rows(torch.ones((8, 16, 128), device=dev,
                                dtype=torch.bfloat16))
            kv = rows(torch.ones((8, 16, 64, 128), device=dev,
                                 dtype=torch.bfloat16))
            kv_len = torch.full((8,), 64, device=dev, dtype=torch.int32)
            refused = {
                "decode_attention": _refuses(lambda: ops.decode_attention(
                    q, kv, kv, kv_len, impl="kernel")),
                "flash_attention": _refuses(lambda: ops.flash_attention(
                    kv, kv, kv, impl="kernel"))}
            if not all(refused.values()):
                fail(f"a kernel wrapper took a DTensor: {refused}")
            out["refused"] = refused
            del sp
            out["train"] = _sharded_train(cfg, params, mesh, rows)
            t = time.perf_counter()
            out.update(_sharded_families(rows))
            out["families_s"] = time.perf_counter() - t
        finally:
            dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    out["dryrun"] = _dryrun_records()
    out["phase_s"] = time.perf_counter() - t0
    emit({"sharded": out, "card": card, "torch": torch.__version__})
    return out


def _path_launches(results, name: str) -> list[int]:
    """Kernel ``name``'s count in every launch-count dict that the paths'
    results hold (under a ``launches`` key, at any depth)."""
    found = []

    def walk(x):
        if isinstance(x, dict):
            for k, v in x.items():
                if k == "launches" and isinstance(v, dict):
                    found.append(v[name])
                else:
                    walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(results)
    if not found:
        fail(f"no path recorded launch counts for {name}")
    return found


def main() -> int:
    if os.environ.get("PYTHONHASHSEED") != "0":
        # The trials' prompts hash (task, TODO) pairs: a fixed hash seed
        # makes every run's prompts, and so its digests, the same.
        os.execve(sys.executable,
                  [sys.executable, os.path.abspath(__file__), *sys.argv[1:]],
                  {**os.environ, "PYTHONHASHSEED": "0"})
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is present", file=sys.stderr)
        return 2
    from repro_torch.kernels import build, ops

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
    bench = bench_merge_phase()
    emit({"bench_merge": bench, "card": card})
    t_tables = time.perf_counter()
    paper = tables_phase()
    emit({"paper_tables": paper, "card": card})
    added_s = time.perf_counter() - t_tables
    bench_serving = serving_bench_phase(card)
    emit({"serving_bench": bench_serving, "card": card})
    cfg, params, serving, streams = serving_phase()
    emit({"serving": serving, "card": card})
    t_added = time.perf_counter()
    olmo_spec = olmo_spec_phase(cfg, params, serving, streams)
    emit({"olmo_spec": olmo_spec, "card": card})
    added_s += time.perf_counter() - t_added
    t_new = time.perf_counter()
    swap = swap_phase(cfg, params)
    swap["phase_s"] = time.perf_counter() - t_new
    emit({"swap": {k: v for k, v in swap.items() if k not in ("on", "off")},
          "card": card})
    new_s = swap["phase_s"]
    trial, trial_counts = trial_phase(cfg, params)
    emit({"trial_mid_step": trial["mid_trial_step"], "card": card})
    t_added = time.perf_counter()
    trial_h = spec_trial(cfg, params, trial["a"])
    added_s += time.perf_counter() - t_added
    disagg = disagg_phase(cfg, params)
    emit({"disagg_serving": {k: v for k, v in disagg.items()
                             if k.startswith("streams")}, "card": card})
    trial_g = replicated_trial(cfg, params)
    fused = fused_coord_phase(cfg, params, card)
    ops.reset_launch_counts()
    sharded = sharded_phase(cfg, params, card)
    if sum(ops.launch_counts().values()):
        fail(f"the sharded phase launched kernels {ops.launch_counts()}")
    del params                  # training takes the card's memory next
    gc.collect()
    torch.cuda.empty_cache()
    training = training_phases(card)
    gc.collect()                # the MLA model takes the card next
    torch.cuda.empty_cache()
    mla_cfg, mla_params, mla_serving, streams = mla_serving_phase()
    emit({"mla_serving": mla_serving, "card": card})
    t_added = time.perf_counter()
    mla_spec = mla_spec_phase(mla_cfg, mla_params, mla_serving, streams)
    emit({"mla_spec": mla_spec, "card": card})
    added_s += time.perf_counter() - t_added
    trial_e = mla_trial(mla_cfg, mla_params)
    del mla_params              # the MoE models take the card next
    gc.collect()
    torch.cuda.empty_cache()
    phases = {}
    for name, phase in (("moe", moe_phase), ("dense_moe", dense_moe_phase)):
        t_new = time.perf_counter()
        phases[name] = phase()
        phases[name]["phase_s"] = time.perf_counter() - t_new
        new_s += phases[name]["phase_s"]
        emit({f"{name}_serving": phases[name], "card": card})
        gc.collect()            # one 16 B-parameter model at a time
        torch.cuda.empty_cache()
    moe, dense_moe = phases["moe"], phases["dense_moe"]
    rec_cfg, rec_params, rec_serving, streams = recurrent_serving_phase()
    emit({"recurrent_serving": rec_serving, "card": card})
    t_added = time.perf_counter()
    rec_spec = recurrent_spec_phase(rec_cfg, rec_params, rec_serving,
                                    streams)
    emit({"recurrent_spec": rec_spec, "card": card})
    added_s += time.perf_counter() - t_added
    del streams
    trial_f = recurrent_trial(rec_cfg, rec_params)
    del rec_params
    gc.collect()
    torch.cuda.empty_cache()
    t_new = time.perf_counter()
    xlstm = xlstm_phase()
    xlstm["phase_s"] = time.perf_counter() - t_new
    new_s += xlstm["phase_s"]
    emit({"xlstm_serving": xlstm, "card": card})
    gc.collect()                # so the peak memory read is whisper's own
    torch.cuda.empty_cache()
    whisper = whisper_phase()
    emit({"whisper_serving": whisper, "card": card})
    gc.collect()
    torch.cuda.empty_cache()
    t_new = time.perf_counter()
    paligemma = paligemma_phase()
    emit({"paligemma_serving": paligemma, "card": card})
    gc.collect()
    torch.cuda.empty_cache()
    long = long_prompt_phase()
    emit({"long_prompt": long, "card": card})
    pg_long_s = time.perf_counter() - t_new
    # Launches: the float kernels and linear_scan on the serving
    # workloads, the quantized kernels on trials (a) and (e),
    # page_transfer on the disaggregated run with adoption on,
    # flash_attention on the whisper Engine, delta_apply on bench_merge,
    # each path's counts read right after its run.  lww_merge has no path:
    # its count is summed over every path's counts, and must be 0.
    paths = [bench, paper, bench_serving, serving, olmo_spec, swap, trial,
             trial_h, disagg,
             trial_g, fused, mla_serving, mla_spec, trial_e, moe, dense_moe,
             rec_serving, rec_spec, trial_f, xlstm, whisper, paligemma,
             long]
    lww = _path_launches(paths, "lww_merge")
    if sum(lww) != 0:
        fail(f"a path launched lww_merge, which none calls: {lww}")
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
                "page_transfer": disagg["on"]["page_transfer_launches"],
                "flash_attention":
                whisper["kernel"]["launches"]["flash_attention"],
                "delta_apply": bench["launches"]["delta_apply"],
                "lww_merge": sum(lww)}
    spec_paths = {
        "paged_chunk_attention": olmo_spec["bf16_ngram"]["launches"]
        ["paged_chunk_attention"],
        "paged_chunk_attention_quant": olmo_spec["int8_ngram"]["launches"]
        ["paged_chunk_attention_quant"],
        "paged_mla_chunk": mla_spec["bf16_ngram"]["launches"]
        ["paged_mla_chunk"],
        "paged_mla_chunk_quant": mla_spec["int8_ngram"]["launches"]
        ["paged_mla_chunk_quant"],
        "linear_scan": rec_spec["ngram"]["launches"]["linear_scan"]}
    # The MoE, xLSTM and swap paths (PR 25): DeepSeek-V2-Lite's scheduler
    # (bf16 / int8 latent pools) and paged Engine, deepseek-moe-16b's
    # scheduler, OLMo's swap-on run.
    new_paths = {
        "paged_mla_chunk": {"moe_launches": moe["scheduler"]["launches"]
                            ["paged_mla_chunk"]},
        "paged_mla_chunk_quant": {"moe_launches": moe["scheduler_int8"]
                                  ["launches"]["paged_mla_chunk_quant"]},
        "paged_mla_decode": {"moe_launches": moe["engine_paged"]["launches"]
                             ["paged_mla_decode"]},
        "paged_chunk_attention": {
            "dense_moe_launches": dense_moe["scheduler"]["launches"]
            ["paged_chunk_attention"],
            "swap_launches": swap["on"]["launches"]
            ["paged_chunk_attention"]}}
    for row in kernels:
        row["launches"] = launches[row["name"]]
        if row["name"] == "decode_attention":
            # Its second main path: the recurrent model's dense Engine.
            row["d256_launches"] = (rec_serving["engine_dense"]["launches"]
                                    ["decode_attention"])
            # Its third: the whisper decoder's self-attention, head_dim 64.
            row["d64_launches"] = (whisper["kernel"]["launches"]
                                   ["decode_attention"])
            # Its fourth: the tables' sim-LLM trials, head_dim 16.
            row["sim_launches"] = paper["launches"]["decode_attention"]
            # Its fifth and sixth: PaliGemma's dense Engine at
            # head_dim 256, and the long prompt's decode past 16k keys.
            row["pg_launches"] = (paligemma["dense"]["kernel"]["launches"]
                                  ["decode_attention"])
            row["long_launches"] = (long["kernel"]["launches"]
                                    ["decode_attention"])
        if row["name"] == "paged_decode_attention":
            # PaliGemma's paged Engine at head_dim 256.
            row["d256_launches"] = (paligemma["paged"]["kernel"]["launches"]
                                    ["paged_decode_attention"])
        if row["name"] in FUSED_KERNEL.values():
            # The fused decode + coordination step (pmax, every step).
            row["fused_launches"] = fused[
                "paged" if row["name"] == "paged_decode_attention"
                else "dense"]["fused_launches"]
        if row["name"] in spec_paths:
            # The speculative runs' verify steps, at their span widths.
            row["spec_launches"] = spec_paths[row["name"]]
        row.update(new_paths.get(row["name"], {}))
        if row["name"] in BENCH_KERNELS + ("decode_attention",):
            # The serving benchmark (PR 29): its full run, and the quick
            # run the gate reads.
            row["bench_launches"] = bench_serving["launches"][row["name"]]
            row["bench_quick_launches"] = (
                bench_serving["quick_launches"][row["name"]])
        row["kernel_ms"] = row["ms"]
        emit({"kernel": row["name"], **row})
    emit({"added_phases_s": added_s, "moe_xlstm_swap_phases_s": new_s,
          "paligemma_long_phases_s": pg_long_s,
          "training_phases_s": training["phases_s"],
          "fused_coord_phase_s": fused["phase_s"],
          "sharded_phase_s": sharded["phase_s"],
          "serving_bench_phase_s": bench_serving["phase_s"],
          "total_s": time.perf_counter() - t0})
    emit({"card": card}, stamp=False)
    emit({"kernels": kernels}, stamp=False)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}},
         stamp=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
