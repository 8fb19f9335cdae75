"""Serving benchmark (the port's copy of the JAX package's
``benchmarks/bench_serving.py``): dense vs paged KV cache under continuous
batching,
the chunked-vs-stalled admission sweep of the token-budget mixed step, the
replicated page-table sweep (N engines gossiping one CRDT page table:
sync bytes per step + cross-replica shared-prefix resolution), and the
speculative-decoding sweep (off vs prompt-lookup vs CRDT-doc drafting:
accept rate, committed tokens/step, µs/accepted-token, stream identity),
the quantized page-pool sweep (off vs int8 vs fp8: resident-capacity gain,
analytic read bytes/step, logit-error report, greedy-stream identity), and
the tiered-memory sweep (host-swap preemption vs recompute-from-scratch).

Sweeps batch × context-length skew × cache layout and reports, per config:

  us_per_token            median step wall time / mean active rows
  write_bytes_per_step    cache bytes *written* per decode step (analytic)
  read_bytes_per_step     cache bytes *read* per decode step (analytic)
  resident_cache_mb       KV bytes pinned at the live-token watermark
  decode_stall_steps      steps where a decode-ready lane got no budget
  ttft_steps / ttft_ms    admission → first token
  itl_p50 / itl_p99       inter-token latency across all requests

The write accounting is the point of the original exercise: the dense
path's analytic count is the full [B, Hkv, S, D] cache per layer per step
(O(B·max_len)), as JAX's one-hot ``jnp.where`` rewrites it, while the
paged path writes one page slot per row (O(page)).  The ``chunked_admission`` sweep is the mixed step's
headline: stalled (whole-prompt, decode lanes idle — the old bucketed
admission) vs chunked (≤ chunk-size prompt slices interleaved with decode
spans) — chunked holds decode_stall_steps at zero while the stalled
baseline idles every in-flight lane per admission.

  PYTHONPATH=src python -m repro_torch.benchmarks.bench_serving [--quick] \\
      [--out PATH] [--device cpu]

The sweeps run on the card unless ``--device cpu``: the scheduler's,
engines' and server's kernels (``paged_chunk_attention``, its ``_quant``
twin, ``paged_decode_attention`` and its twin, ``decode_attention``,
``page_transfer``) on a card, their plain versions on the CPU.  The
analytic byte counters are functions of the cache trees' shapes, the
same on both.  Prints ``name,us_per_call,derived`` CSV rows (the harness
contract); the report goes to ``BENCH_serving_torch.json`` and the
quant-error report to ``BENCH_quant_error_torch.json`` beside it.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.benchmarks import roofline

OUT = "BENCH_serving_torch.json"
QUANT_OUT = "BENCH_quant_error_torch.json"


def _abstract_cache(cfg, *, batch: int, max_len: int, page_size: int,
                    paged: bool, kv_quant: str = "off"):
    """Shape-only cache tree (``meta`` tensors) for byte accounting."""
    return roofline.abstract_cache(cfg, batch, max_len, paged=paged,
                                   page_size=page_size, kv_quant=kv_quant)


def _device(params) -> torch.device:
    return params["embed"]["w"].device


def _top2_gap(logits: np.ndarray) -> float:
    """The top-1 / top-2 gap of one row of logits."""
    top2 = np.sort(logits.astype(np.float64))[-2:]
    return float(top2[1] - top2[0])


@torch.no_grad()
def _first_diff_gaps(cfg, params, prompts, streams0: dict,
                     streams: dict) -> list[float]:
    """For each request whose stream differs from the reference's, the
    reference model's top-2 gap at the first differing token (one plain
    forward over prompt + the reference's tokens before it): how near a
    tie the two runs parted at."""
    from repro_torch.models import lm
    gaps = []
    for rid, ref in streams0.items():
        got = streams[rid]
        if got == ref:
            continue
        j = next((i for i, (a, b) in enumerate(zip(ref, got)) if a != b),
                 min(len(ref), len(got)))
        seq = torch.as_tensor([list(prompts[rid]) + ref[:j]],
                              device=_device(params))
        logits, _ = lm.forward(params, cfg, seq)
        gaps.append(_top2_gap(logits[0, -1].float().cpu().numpy()))
    return gaps


def analytic_step_bytes(cfg, *, batch: int, max_len: int, page_size: int,
                        live_lens: list[int], paged: bool,
                        kv_quant: str = "off") -> tuple[int, int]:
    """(write_bytes, read_bytes) of KV-cache traffic for ONE decode step.

    Dense: the one-hot masked select produces a full new cache value per
    attention layer (write = |cache|) after streaming the old one (read =
    |cache|).  Paged: one slot write per row; reads walk only live pages.

    ONE code path for dense / paged / quantized: every byte count is
    derived from the cache tree's own leaf shapes+dtypes via the same
    helpers roofline.py uses (kv_slot_bytes / kv_page_bytes /
    dense_kv_bytes), so a quantized pool automatically counts its int8/fp8
    payload plus the f32 per-row scale leaves, and the bench agrees with
    the roofline model by construction.
    """
    cache = _abstract_cache(cfg, batch=batch, max_len=max_len,
                            page_size=page_size, paged=paged,
                            kv_quant=kv_quant)
    if not paged:
        total = roofline.dense_kv_bytes(cache)
        return total, total
    write = batch * roofline.kv_slot_bytes(cache)
    read = sum(-(-(l + 1) // page_size) for l in live_lens) \
        * roofline.kv_page_bytes(cache)
    return write, read


def analytic_slot_bytes(cfg, *, batch: int, max_len: int, page_size: int,
                        kv_quant: str = "off") -> int:
    """Bytes one cached token pins across all paged layers (pool + scales)."""
    return roofline.kv_slot_bytes(_abstract_cache(
        cfg, batch=batch, max_len=max_len, page_size=page_size, paged=True,
        kv_quant=kv_quant))


def _quantile(xs: list[float], q: float) -> float:
    if not xs:
        return 0.0
    xs = sorted(xs)
    i = min(len(xs) - 1, int(round(q * (len(xs) - 1))))
    return xs[i]


def run_config(cfg, params, *, batch: int, max_len: int, page_size: int,
               skew: str, paged: bool, n_requests: int, prompt_hi: int,
               max_new: int, seed: int = 0, chunk_size: int = 32,
               interleave: bool = True, stagger: bool = False,
               kv_quant: str = "off") -> dict:
    from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

    rng = np.random.default_rng(seed)
    if skew == "uniform":
        plens = [prompt_hi] * n_requests
    else:                                       # ragged: log-uniform spread
        plens = [int(x) for x in np.exp(rng.uniform(
            np.log(4), np.log(prompt_hi), n_requests)).astype(int)]
    # ``stagger`` varies generation lengths so completions (and therefore
    # admissions) interleave with decode — the regime where stalled
    # admission actually stalls lanes.
    news = [max(1, max_new // 2 + (i * 3) % max_new) if stagger else max_new
            for i in range(n_requests)]
    requests = [Request(rid=i,
                        prompt=[int(t) for t in
                                rng.integers(2, cfg.vocab_size, p)],
                        max_new_tokens=news[i])
                for i, p in enumerate(plens)]

    eng = ContinuousBatchingEngine(cfg, params, batch=batch, max_len=max_len,
                                   paged=paged, page_size=page_size,
                                   chunk_size=chunk_size,
                                   prefill_interleave=interleave,
                                   kv_quant=kv_quant, device=_device(params))
    for r in requests:
        eng.submit(r)
    step_times: list[float] = []
    step_stamps: list[float] = [time.perf_counter()]
    active_counts: list[int] = []
    live_len_samples: list[list[int]] = []
    resident_peak = 0
    tok_stamp: dict[int, list[float]] = {r.rid: [] for r in requests}
    tok_seen = {r.rid: 0 for r in requests}
    while True:
        live = [len(r.prompt) + len(r.tokens)
                for r in eng.rows if r is not None]
        t0 = time.perf_counter()
        more = eng.step()
        now = time.perf_counter()
        step_times.append(now - t0)
        step_stamps.append(now)
        for r in requests:                      # per-token arrival stamps
            while tok_seen[r.rid] < len(r.tokens):
                tok_stamp[r.rid].append(now)
                tok_seen[r.rid] += 1
        if live:
            active_counts.append(len(live))
            live_len_samples.append(live)
        resident_peak = max(resident_peak, eng.resident_cache_bytes())
        if not more:
            break
        if eng.stats["steps"] > 50_000:
            raise RuntimeError("bench runaway")

    # Median step time strips compile outliers (first call per bucket/shape).
    med_step = statistics.median(step_times)
    mean_active = statistics.fmean(active_counts) if active_counts else 0.0
    mid_lens = live_len_samples[len(live_len_samples) // 2] \
        if live_len_samples else []
    wb, rb = analytic_step_bytes(cfg, batch=batch, max_len=max_len,
                                 page_size=page_size, live_lens=mid_lens,
                                 paged=paged, kv_quant=kv_quant)
    admitted_mid_flight = sum(1 for r in requests if r.admitted_step > 0)
    # TTFT in steps is deterministic (greedy, fixed seeds); wall TTFT rides
    # the step timestamps.  Inter-token latency pools per-request diffs.
    ttft_steps = [r.first_token_step - r.admitted_step for r in requests
                  if r.first_token_step >= 0]
    ttft_wall = [step_stamps[min(r.first_token_step, len(step_stamps) - 1)]
                 - step_stamps[min(r.admitted_step, len(step_stamps) - 1)]
                 for r in requests if r.first_token_step >= 0]
    itl = [b - a for stamps in tok_stamp.values()
           for a, b in zip(stamps, stamps[1:])]
    return {
        "batch": batch, "skew": skew, "mode": "paged" if paged else "dense",
        "kv_quant": kv_quant,
        "max_len": max_len, "page_size": page_size,
        "chunk_size": chunk_size, "interleave": interleave,
        "n_requests": n_requests, "gen_tokens": eng.stats["gen_tokens"],
        "steps": eng.stats["steps"], "prefills": eng.stats["prefills"],
        "prefill_chunks": eng.stats["prefill_chunks"],
        "us_per_token": 1e6 * med_step / max(mean_active, 1e-9),
        "us_per_step": 1e6 * med_step,
        "mean_active_rows": mean_active,
        "write_bytes_per_step": wb,
        "read_bytes_per_step": rb,
        "resident_cache_mb": resident_peak / 2**20,
        "peak_pages": eng.stats["peak_pages"],
        "admitted_mid_flight": admitted_mid_flight,
        "completed": eng.stats["completed"],
        "decode_stall_steps": eng.stats["decode_stall_steps"],
        "stalled_lane_steps": eng.stats["stalled_lane_steps"],
        "ttft_steps_mean": (statistics.fmean(ttft_steps)
                            if ttft_steps else 0.0),
        "ttft_steps_max": max(ttft_steps, default=0),
        "ttft_ms_mean": 1e3 * (statistics.fmean(ttft_wall)
                               if ttft_wall else 0.0),
        "itl_p50_us": 1e6 * _quantile(itl, 0.50),
        "itl_p99_us": 1e6 * _quantile(itl, 0.99),
    }


def run_chunked_admission(cfg, params, *, batch: int, max_len: int,
                          page_size: int, n_requests: int, prompt_hi: int,
                          max_new: int, chunks: tuple[int, ...]) -> list[dict]:
    """Chunked vs stalled admission sweep (the mixed-step headline).

    ``stalled`` emulates the old bucketed-admission scheduler: prompts land
    whole and decode lanes idle while any admission is in flight.  Each
    ``chunked`` row interleaves ≤ chunk-size prompt slices with decode spans
    — decode_stall_steps drops to zero and inter-token latency flattens,
    at the cost of more (smaller) steps per admission.
    """
    rows = []
    base = dict(batch=batch, max_len=max_len, page_size=page_size,
                skew="ragged", paged=True, n_requests=n_requests,
                prompt_hi=prompt_hi, max_new=max_new, stagger=True)
    row = run_config(cfg, params, interleave=False, chunk_size=max_len,
                     **base)
    row["admission"] = "stalled"
    rows.append(row)
    for chunk in chunks:
        row = run_config(cfg, params, interleave=True, chunk_size=chunk,
                         **base)
        row["admission"] = "chunked"
        rows.append(row)
    return rows


def run_prefix_share(cfg, params, *, max_len: int, page_size: int,
                     fanout: int, prompt_len: int, max_new: int,
                     share: bool, seed: int = 0) -> dict:
    """Fan-out of ``fanout`` agents forked from ONE shared prompt.

    With ``share=True`` the scheduler's copy-on-write prefix sharing is on:
    the clones' prompt pages are refcounted aliases of the first admission's
    pages, duplicated only when a row is about to write into one.  Reports
    peak resident KV MB and per-admission µs for the with/without-COW
    comparison column.
    """
    from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

    rng = np.random.default_rng(seed)
    prompt = [int(t) for t in rng.integers(2, cfg.vocab_size, prompt_len)]
    requests = [Request(rid=i, prompt=list(prompt), max_new_tokens=max_new)
                for i in range(fanout)]
    eng = ContinuousBatchingEngine(cfg, params, batch=fanout,
                                   max_len=max_len, paged=True,
                                   page_size=page_size, prefix_sharing=share,
                                   device=_device(params))
    # Warm the prefill bucket / decode shapes so admission_us measures the
    # steady-state admission path, not the jit compile.
    eng.run([Request(rid=-1, prompt=list(prompt), max_new_tokens=max_new)])
    eng.stats.update(admit_s=0.0, prefills=0, peak_pages=0,
                     shared_pages=0, cow_copies=0, completed=0)
    for r in requests:
        eng.submit(r)
    resident_peak = 0
    while True:
        more = eng.step()
        resident_peak = max(resident_peak, eng.resident_cache_bytes())
        if not more:
            break
        if eng.stats["steps"] > 50_000:
            raise RuntimeError("prefix-share bench runaway")
    s = eng.stats
    return {
        "fanout": fanout, "prompt_len": prompt_len, "max_new": max_new,
        "page_size": page_size, "cow": share,
        "resident_cache_mb": resident_peak / 2**20,
        "peak_pages": s["peak_pages"],
        "admission_us": 1e6 * s["admit_s"] / max(s["prefills"], 1),
        "shared_pages": s["shared_pages"], "cow_copies": s["cow_copies"],
        "completed": s["completed"],
    }


def run_replicated(cfg, params, *, replicas: int, batch: int, max_len: int,
                   page_size: int, prompt_len: int, max_new: int,
                   sync_every: int = 1, seed: int = 0) -> dict:
    """Staggered shared-prefix fan-out across ``replicas`` engine replicas.

    Requests arrive in an ``A A B B ...`` pattern over two distinct prompts,
    sized so round-robin dispatch lands BOTH prompts on EVERY replica.  The
    first admitter of each prompt publishes its immutable full prefix pages
    into the replicated CRDT map; later admissions of the same prompt on
    *other* replicas then resolve those pages through the gossip'd metadata
    (``cross_replica_hits`` — the coordination-layer signal this sweep
    gates on) while local re-admissions hit the ordinary COW prefix cache.
    Also reports the anti-entropy wire cost (``sync_bytes_per_step``) and
    asserts bitwise page-table convergence across replicas at drain.
    """
    from repro_torch.serving.replicated import MultiEngineServer
    from repro_torch.serving.scheduler import Request

    rng = np.random.default_rng(seed)
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab_size, prompt_len)]
               for _ in range(2)]
    # Round-robin sends request i to replica i % R.  Wave w = i // R gives
    # the first half of the replicas prompt A and the rest prompt B, then
    # SWAPS every wave — so each replica's queue alternates prompts and its
    # later admissions land after a peer has published that prompt's pages.
    n_requests = 4 * replicas
    def _prompt_idx(i: int) -> int:
        half = 0 if 2 * (i % replicas) < replicas else 1
        return (half + i // replicas) % 2
    requests = [Request(rid=i, prompt=list(prompts[_prompt_idx(i)]),
                        max_new_tokens=max_new)
                for i in range(n_requests)]
    server = MultiEngineServer(cfg, params, replicas=replicas, batch=batch,
                               max_len=max_len, page_size=page_size,
                               sync_every=sync_every, chunk_size=page_size,
                               device=_device(params))
    for r in requests:
        server.submit(r)
    step_times: list[float] = []
    while True:
        t0 = time.perf_counter()
        more = server.step()
        step_times.append(time.perf_counter() - t0)
        if not more:
            break
        if server.clock > 50_000:
            raise RuntimeError("replicated bench runaway")
    server.sync()                           # final round: frontiers settle
    s = server.stats()
    med_step = statistics.median(step_times)
    return {
        "replicas": replicas, "batch": batch, "page_size": page_size,
        "sync_every": sync_every, "n_requests": n_requests,
        "prompt_len": prompt_len,
        "us_per_step": 1e6 * med_step,
        "steps": s["steps"], "syncs": s["syncs"],
        "gen_tokens": s["gen_tokens"], "completed": s["completed"],
        "sync_bytes": s["sync_bytes"],
        "sync_bytes_per_step": s["sync_bytes_per_step"],
        "cross_replica_hits": s["cross_replica_hits"],
        "published_prefix_pages": s["published_prefix_pages"],
        "shared_pages": s["shared_pages"],
        "converged": server.converged(),
    }


def run_disagg(cfg, params, *, replicas: int, batch: int, max_len: int,
               page_size: int, prompt_len: int, max_new: int,
               adopt: bool, seed: int = 0) -> tuple[dict, dict]:
    """Disaggregated prefill/decode sweep: one prefill replica + decode
    replicas over the CRDT page table, staggered shared-prefix arrivals.

    The first ``batch`` requests arrive at t=0 (cold — routed to the
    prefill replica); the rest arrive one per step, so same-prompt
    followers land after the prefill replica has published its filled
    pages and routing steers them to the decode tier.  With
    ``adopt=True`` the decode replicas' adoption hooks physically transfer
    the published pages (rule-3 commit) and admission skips the covered
    prefill chunks; ``adopt=False`` is the local-prefill baseline —
    identical topology, routing, and publication, but every decode
    admission recomputes its prompt.  Returns ``(row, streams)`` where
    ``streams`` maps rid -> generated tokens (the acceptance section
    checks the two sweeps match token-for-token: adoption is bitwise).
    """
    from repro_torch.serving.replicated import MultiEngineServer
    from repro_torch.serving.scheduler import Request

    rng = np.random.default_rng(seed)
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab_size, prompt_len)]
               for _ in range(2)]
    n_requests = 4 * replicas
    requests = [Request(rid=i, prompt=list(prompts[(i // 2) % 2]),
                        max_new_tokens=max_new)
                for i in range(n_requests)]
    roles = ["prefill"] + ["decode"] * (replicas - 1)
    server = MultiEngineServer(cfg, params, replicas=replicas, batch=batch,
                               max_len=max_len, page_size=page_size,
                               sync_every=1, chunk_size=page_size,
                               roles=roles, adopt_pages=adopt,
                               device=_device(params))
    pending = list(requests)
    for req in pending[:batch]:
        server.submit(req)
    pending = pending[batch:]
    step_times: list[float] = []
    while True:
        t0 = time.perf_counter()
        more = server.step()
        step_times.append(time.perf_counter() - t0)
        if pending:
            server.submit(pending.pop(0))
            continue
        if not more:
            break
        if server.clock > 50_000:
            raise RuntimeError("disagg bench runaway")
    server.sync()                           # final round: frontiers settle
    s = server.stats()
    ttft = [r.first_token_step - r.admitted_step for r in requests
            if r.first_token_step >= 0]
    row = {
        "adoption": "on" if adopt else "off",
        "replicas": replicas, "batch": batch, "page_size": page_size,
        "n_requests": n_requests, "prompt_len": prompt_len,
        "us_per_step": 1e6 * statistics.median(step_times),
        "steps": s["steps"],
        "gen_tokens": s["gen_tokens"], "completed": s["completed"],
        "ttft_steps_mean": (statistics.fmean(ttft) if ttft else 0.0),
        "ttft_steps_max": max(ttft, default=0),
        "adopted_pages": s["adopted_pages"],
        "adopted_tokens": s["adopted_tokens"],
        "prefill_steps_avoided": s["prefill_steps_avoided"],
        "transferred_pages": s["transferred_pages"],
        "transfer_bytes": s["transfer_bytes"],
        "transfer_bytes_per_step": (s["transfer_bytes"] // s["steps"]
                                    if s["steps"] else 0),
        "adopt_aborts": s["adopt_aborts"],
        "cross_replica_hits": s["cross_replica_hits"],
        "published_prefix_pages": s["published_prefix_pages"],
        "sync_bytes_per_step": s["sync_bytes_per_step"],
        "converged": server.converged(),
    }
    streams = {r.rid: list(r.tokens) for r in requests}
    return row, streams


def _fault_row(trace: dict, base_steps: int) -> dict:
    srv = trace["server"]
    return {
        "schedule": trace["schedule"],
        # -1 marks the fault-free reference run of the same workload.
        "crash_at": -1 if trace["crash_replica"] is None
        else trace["crash_at"],
        "steps": trace["steps"],
        "recovery_step_overhead": trace["steps"] - base_steps,
        "completed": srv["completed"],
        "gen_tokens": srv["gen_tokens"],
        "goodput_tokens_per_step": srv["gen_tokens"] / max(trace["steps"], 1),
        "recovered": srv["recovered_requests"],
        "retried": srv["retried"],
        "shed": srv["shed"],
        "expired": srv["expired"],
        "lost": srv["lost_requests"],
        "failed": srv["failed_requests"],
        "ok": trace["ok"],
    }


def run_fault_sweep(cfg, params, *, schedules: tuple[str, ...],
                    crash_ats: tuple[int, ...], seed: int = 0) -> list[dict]:
    """Crash-failover sweep over the REAL multi-engine server (chaos
    harness): each row is one seeded (fault schedule x crash step) trial
    plus one fault-free reference of the same workload.  Greedy decoding
    and a seeded channel make every counter bit-identical across reruns of
    the same commit, so the regression gate holds them to the strict
    threshold; ``recovery_step_overhead`` (extra steps vs the fault-free
    reference — a TTFT/latency penalty in step units) is the headline
    recovery-cost number."""
    from repro_torch.serving import chaos

    clean = chaos.run_chaos(cfg, params, schedule="lossy", seed=seed,
                            crash_replica=None)
    rows = [_fault_row(clean, clean["steps"])]
    for schedule in schedules:
        for crash_at in crash_ats:
            trace = chaos.run_chaos(cfg, params, schedule=schedule,
                                    seed=seed, crash_at=crash_at)
            rows.append(_fault_row(trace, clean["steps"]))
    return rows


def run_spec_decode(cfg, params, *, batch: int, max_len: int, page_size: int,
                    n_requests: int, prompt_hi: int, max_new: int,
                    spec_k: int = 4, chunk_size: int = 16,
                    seed: int = 0) -> list[dict]:
    """Speculative-decoding sweep: off vs prompt-lookup vs CRDT-doc drafting.

    One shared workload of motif-repeating prompts (the code-generation
    regime prompt lookup targets: trailing n-grams recur upstream).  The
    ``off`` row is the greedy reference; every spec row must reproduce its
    token streams exactly (``streams_match``) while finishing in fewer
    steps.  The ``doc`` row seeds the drafter with the reference run's
    converged streams — standing in for CRDT document content the system
    already agreed on, the case where doc-lookup beats own-history n-gram.

    ``us_per_accepted_token`` is the headline: median step wall time over
    committed tokens per step (accepted draft + bonus), the spec-decode
    analogue of µs/token.
    """
    from repro_torch.serving import draft as draft_mod
    from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

    rng = np.random.default_rng(seed)
    prompts = []
    for _ in range(n_requests):
        m = 4 + int(rng.integers(0, 4))
        motif = [int(t) for t in rng.integers(2, cfg.vocab_size, m)]
        tail = [int(t) for t in rng.integers(2, cfg.vocab_size, m)]
        reps = -(-prompt_hi // m)
        prompts.append((motif * reps)[: prompt_hi - len(tail)] + tail)

    def run_mode(mode: str, drafter=None):
        reqs = [Request(rid=i, prompt=list(p), max_new_tokens=max_new)
                for i, p in enumerate(prompts)]
        eng = ContinuousBatchingEngine(
            cfg, params, batch=batch, max_len=max_len, paged=True,
            page_size=page_size, chunk_size=chunk_size,
            spec_decode=mode, spec_k=spec_k, drafter=drafter,
            device=_device(params))
        for r in reqs:
            eng.submit(r)
        times = []
        while True:
            t0 = time.perf_counter()
            more = eng.step()
            times.append(time.perf_counter() - t0)
            if not more:
                break
            if eng.stats["steps"] > 50_000:
                raise RuntimeError("spec-decode bench runaway")
        return eng, reqs, statistics.median(times)

    eng0, reqs0, med0 = run_mode("off")
    streams0 = {r.rid: list(r.tokens) for r in reqs0}
    rows = []
    for mode in ("off", "ngram", "doc"):
        if mode == "off":
            eng, reqs, med = eng0, reqs0, med0
        else:
            drafter = None
            if mode == "doc":
                drafter = draft_mod.DocDrafter()
                drafter.set_docs([list(p) + streams0[i]
                                  for i, p in enumerate(prompts)])
            eng, reqs, med = run_mode(mode, drafter=drafter)
        s = eng.stats
        tps = s["gen_tokens"] / max(s["steps"], 1)
        rows.append({
            "spec": mode, "batch": batch, "spec_k": spec_k,
            "chunk_size": chunk_size, "n_requests": n_requests,
            "steps": s["steps"], "gen_tokens": s["gen_tokens"],
            "draft_tokens": s["draft_tokens"],
            "accepted_tokens": s["accepted_tokens"],
            "rollback_tokens": s["rollback_tokens"],
            "spec_steps": s["spec_steps"],
            "spec_rollbacks": s["spec_rollbacks"],
            "accept_rate": eng.spec_accept_rate,
            "tokens_per_step": tps,
            "us_per_step": 1e6 * med,
            "us_per_accepted_token": 1e6 * med / max(tps, 1e-9),
            "completed": s["completed"],
            "streams_match": all(list(r.tokens) == streams0[r.rid]
                                 for r in reqs),
        })
    return rows


def run_spec_agents(cfg, params, *, spec_k: int = 4, max_len: int = 256,
                    page_size: int = 16, chunk_size: int = 16,
                    seed: int = 0) -> list[dict]:
    """End-to-end agent trial, speculative vs baseline.

    One sequential CodeCRDT task (single writer: no cross-agent
    observation timing, so the whole-trial document digest must match the
    non-speculative run bit-for-bit) run off vs doc-drafted.  Wall clock
    and step count are the e2e speedup numbers; digest equality is the
    e2e correctness gate.
    """
    from repro_torch.agents.orchestrator import run_task
    from repro_torch.agents.tasks import TASKS

    task = TASKS["tic_tac_toe"]
    rows = []
    base = None
    for mode in ("off", "doc"):
        r = run_task(cfg, params, task, mode="sequential", seed=seed,
                     max_len=max_len, kv="paged", prefill="chunked",
                     page_size=page_size, chunk_size=chunk_size,
                     spec_decode=mode, spec_k=spec_k,
                     device=_device(params))
        if base is None:
            base = r
        rows.append({
            "spec": mode, "task": task.name, "wall_s": r.wall_s,
            "steps": r.steps, "gen_tokens": r.gen_tokens,
            "draft_tokens": r.draft_tokens,
            "accepted_tokens": r.accepted_tokens,
            "rollback_tokens": r.rollback_tokens,
            "accept_rate": r.accept_rate,
            "digest_match": r.digest == base.digest,
        })
    return rows


# Documented quant-error budget (model-level logit error vs the bf16-pool
# reference, teacher-forced): int8 per-page-row scales bound element error
# by scale/2 ≈ amax/254; fp8 e4m3 has ~3 mantissa bits, so its budget is
# looser.  Greedy argmax must survive either way.
QUANT_LOGIT_TOL = {"int8": 0.25, "fp8": 0.5}


def _quant_modes():
    from repro_torch.models import cache as cache_mod

    return cache_mod.KV_QUANT_MODES


def run_quant_sweep(cfg, params, *, batch: int, max_len: int, page_size: int,
                    n_requests: int, prompt_hi: int, max_new: int,
                    chunk_size: int = 16, seed: int = 0) -> list[dict]:
    """Quantized page-pool sweep: off vs int8 vs fp8.

    One shared ragged workload through the full engine per mode.  The
    ``off`` row is the bf16-pool reference; the ``int8`` row must
    reproduce its greedy token streams exactly (``streams_match`` — fp8's
    ~3 mantissa bits may flip near-tie argmaxes, so fp8 is held to the
    logit-error budget instead) while reading fewer analytic bytes per
    step and pinning fewer resident MB at the live-token watermark.  ``resident_capacity_gain`` is the headline:
    bytes one cached token pins under bf16 over the same under the quant
    layout (pool + scale leaves) — how many MORE tokens the same pool MB
    can hold.  ``first_diff_gaps`` (the port's own) holds, for each
    request whose stream differs from the ``off`` row's, the bf16 model's
    top-2 gap where they part.
    """
    from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

    rng = np.random.default_rng(seed)
    plens = [int(x) for x in np.exp(rng.uniform(
        np.log(4), np.log(prompt_hi), n_requests)).astype(int)]
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab_size, p)]
               for p in plens]
    base_slot = analytic_slot_bytes(cfg, batch=batch, max_len=max_len,
                                    page_size=page_size, kv_quant="off")
    rows: list[dict] = []
    streams0 = None
    for mode in _quant_modes():
        reqs = [Request(rid=i, prompt=list(p), max_new_tokens=max_new)
                for i, p in enumerate(prompts)]
        eng = ContinuousBatchingEngine(cfg, params, batch=batch,
                                       max_len=max_len, paged=True,
                                       page_size=page_size,
                                       chunk_size=chunk_size, kv_quant=mode,
                                       device=_device(params))
        for r in reqs:
            eng.submit(r)
        times: list[float] = []
        active: list[int] = []
        live_samples: list[list[int]] = []
        resident_peak = 0
        while True:
            live = [len(r.prompt) + len(r.tokens)
                    for r in eng.rows if r is not None]
            t0 = time.perf_counter()
            more = eng.step()
            times.append(time.perf_counter() - t0)
            if live:
                active.append(len(live))
                live_samples.append(live)
            resident_peak = max(resident_peak, eng.resident_cache_bytes())
            if not more:
                break
            if eng.stats["steps"] > 50_000:
                raise RuntimeError("quant bench runaway")
        streams = {r.rid: list(r.tokens) for r in reqs}
        if streams0 is None:
            streams0 = streams
        mid = live_samples[len(live_samples) // 2] if live_samples else []
        wb, rb = analytic_step_bytes(cfg, batch=batch, max_len=max_len,
                                     page_size=page_size, live_lens=mid,
                                     paged=True, kv_quant=mode)
        slot = analytic_slot_bytes(cfg, batch=batch, max_len=max_len,
                                   page_size=page_size, kv_quant=mode)
        med = statistics.median(times)
        mean_active = statistics.fmean(active) if active else 0.0
        rows.append({
            "kv_quant": mode, "batch": batch, "page_size": page_size,
            "n_requests": n_requests, "steps": eng.stats["steps"],
            "gen_tokens": eng.stats["gen_tokens"],
            "completed": eng.stats["completed"],
            "us_per_token": 1e6 * med / max(mean_active, 1e-9),
            "us_per_step": 1e6 * med,
            "write_bytes_per_step": wb,
            "read_bytes_per_step": rb,
            "resident_cache_mb": resident_peak / 2**20,
            "slot_bytes": slot,
            "resident_capacity_gain": base_slot / slot,
            "streams_match": streams == streams0,
            "first_diff_gaps": _first_diff_gaps(cfg, params, prompts,
                                                streams0, streams),
        })
    return rows


def quant_error_report(cfg, params, *, max_len: int = 64, page_size: int = 8,
                       prompt_len: int = 12, decode_steps: int = 12,
                       seed: int = 0) -> dict:
    """Model-level logit-error report for quantized KV pools (CI artifact).

    Teacher-forces the bf16-pool greedy stream through each quant mode so
    per-step logits are directly comparable, then reports logit MSE,
    max-abs error, and whether the quant run's own greedy argmax matches
    the reference at every step.  Gated against QUANT_LOGIT_TOL.
    ``flip_gaps`` (the port's own) holds, for each step and row whose
    greedy argmax differs, the bf16 pool's top-2 gap there.
    """
    from repro_torch.models import lm

    dev = _device(params)
    rng = np.random.default_rng(seed)
    batch = 2
    tokens = torch.as_tensor(rng.integers(2, cfg.vocab_size,
                                          (batch, prompt_len)),
                             dtype=torch.int32, device=dev)
    maxp = -(-max_len // page_size)
    bt = torch.arange(batch * maxp, dtype=torch.int32,
                      device=dev).reshape(batch, maxp)

    def host(logits) -> np.ndarray:
        return logits.float().cpu().numpy()

    @torch.no_grad()
    def run(mode: str, inputs=None):
        cache = lm.init_cache(cfg, batch, max_len, paged=True,
                              page_size=page_size, kv_quant=mode,
                              device=dev)
        cache = lm.set_block_tables(cache, bt)
        logits, cache = lm.prefill(params, cfg, tokens, cache)
        outs = [host(logits)]
        fed = []
        for t in range(decode_steps):
            nxt = (torch.as_tensor(np.argmax(outs[-1], -1),
                                   dtype=torch.int32, device=dev)
                   if inputs is None else inputs[t])
            fed.append(nxt)
            pos = torch.full((batch,), prompt_len + t, dtype=torch.int32,
                             device=dev)
            logits, cache = lm.decode_step(params, cfg, nxt, cache, pos)
            outs.append(host(logits))
        return outs, fed

    ref_outs, ref_inputs = run("off")
    modes = {}
    for mode in _quant_modes():
        if mode == "off":
            continue
        outs, _ = run(mode, inputs=ref_inputs)
        diffs = [q - r for q, r in zip(outs, ref_outs)]
        max_abs = float(max(np.max(np.abs(d)) for d in diffs))
        greedy = all(np.array_equal(np.argmax(q, -1), np.argmax(r, -1))
                     for q, r in zip(outs, ref_outs))
        flips = [_top2_gap(r[row]) for q, r in zip(outs, ref_outs)
                 for row in np.flatnonzero(np.argmax(q, -1)
                                           != np.argmax(r, -1))]
        modes[mode] = {
            "logit_mse": float(np.mean([np.mean(d ** 2) for d in diffs])),
            "logit_max_abs": max_abs,
            "greedy_match": bool(greedy),
            "flip_gaps": flips,
            "tolerance": QUANT_LOGIT_TOL[mode],
            "within_tol": bool(max_abs <= QUANT_LOGIT_TOL[mode]),
        }
    return {
        "batch": batch, "prompt_len": prompt_len,
        "decode_steps": decode_steps, "page_size": page_size,
        "modes": modes,
        # Greedy identity is an int8 guarantee: fp8 e4m3 (~3 mantissa bits)
        # may legitimately flip near-tie argmaxes and is held only to the
        # logit-error budget.
        "greedy_match_int8": modes["int8"]["greedy_match"],
        "all_within_tol": all(m["within_tol"] for m in modes.values()),
    }


def run_swap_sweep(cfg, params, *, max_len: int = 64, page_size: int = 8,
                   num_pages: int = 6, chunk_size: int = 8,
                   prompt_lens: tuple[int, ...] = (24, 6), max_new: int = 16,
                   swap_tier_pages: int = 8, kv_quant: str = "off",
                   seed: int = 0) -> list[dict]:
    """Tiered host-swap page memory vs recompute-from-scratch preemption.

    A deliberately undersized pool (``num_pages`` < both rows' peak) forces
    LRU preemption of the long-context row mid-decode.  The ``recompute``
    reference (swap tier disabled) re-admits the victim by re-prefilling
    its whole context in chunk-size slices; the ``swap`` run copies the
    victim's private pages to a host swap pool at eviction and streams
    them back on re-admission, so only the context *tail* re-prefills.
    Gate: same token streams, strictly fewer steps, and the swap run's
    swap/preempt counters prove the tier actually engaged.
    """
    from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

    rng = np.random.default_rng(seed)
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab_size, p)]
               for p in prompt_lens]
    rows: list[dict] = []
    streams0 = None
    for tier in (0, swap_tier_pages):
        reqs = [Request(rid=i, prompt=list(p), max_new_tokens=max_new)
                for i, p in enumerate(prompts)]
        eng = ContinuousBatchingEngine(
            cfg, params, batch=len(prompts), max_len=max_len, paged=True,
            page_size=page_size, num_pages=num_pages, chunk_size=chunk_size,
            kv_quant=kv_quant, swap_tier_pages=tier,
            swap_min_tokens=2 * page_size, device=_device(params))
        for r in reqs:
            eng.submit(r)
        times: list[float] = []
        while True:
            t0 = time.perf_counter()
            more = eng.step()
            times.append(time.perf_counter() - t0)
            if not more:
                break
            if eng.stats["steps"] > 50_000:
                raise RuntimeError("swap bench runaway")
        streams = {r.rid: list(r.tokens) for r in reqs}
        if streams0 is None:
            streams0 = streams
        s = eng.stats
        rows.append({
            "tier": "swap" if tier else "recompute",
            "swap_tier_pages": tier, "num_pages": num_pages,
            "page_size": page_size, "kv_quant": kv_quant,
            "steps": s["steps"], "completed": s["completed"],
            "gen_tokens": s["gen_tokens"],
            "preempt_swap": s["preempt_swap"],
            "preempt_recompute": s["preempt_recompute"],
            "swap_outs": s["swap_outs"], "swap_ins": s["swap_ins"],
            "us_per_step": 1e6 * statistics.median(times),
            "streams_match": streams == streams0,
        })
    return rows


def run_bench(quick: bool = False, out: str | Path = OUT,
              emit_csv=print, swap_tier_pages: int = 8, device=None) -> dict:
    """Every sweep on the sim LLM on ``device`` (the card unless
    ``"cpu"``); writes ``out`` and the quant-error report ``QUANT_OUT``
    beside it."""
    from repro_torch.agents.orchestrator import make_sim_llm
    from repro_torch.models import lm

    cfg, params = make_sim_llm(device=device)
    max_len = 128 if quick else 256
    page_size = 16
    max_new = 8 if quick else 16
    batches = (4,) if quick else (4, 8)
    prompt_hi = max_len - max_new - 1
    rows = []
    for batch in batches:
        n_requests = 2 * batch + 2              # forces mid-flight admission
        for skew in ("uniform", "ragged"):
            for paged in (False, True):
                rows.append(run_config(
                    cfg, params, batch=batch, max_len=max_len,
                    page_size=page_size, skew=skew, paged=paged,
                    n_requests=n_requests, prompt_hi=prompt_hi,
                    max_new=max_new))

    # Chunked-vs-stalled admission sweep (TTFT, decode-stall steps, p50/p99
    # inter-token latency) — the token-budget mixed step's headline.
    chunk_rows = run_chunked_admission(
        cfg, params, batch=batches[0], max_len=max_len,
        page_size=page_size, n_requests=2 * batches[0] + 2,
        prompt_hi=prompt_hi, max_new=max_new,
        chunks=(page_size, 2 * page_size) if quick
        else (page_size // 2, page_size, 2 * page_size))

    # Prefix-share sweep: shared-prompt fan-out, with/without COW sharing.
    share_rows = []
    fanouts = (4,) if quick else (2, 4, 8)
    for fanout in fanouts:
        for share in (False, True):
            # Prompt deliberately NOT page-aligned: the partial boundary
            # page is shared too and every sharer copy-on-writes it at its
            # first generated token.
            share_rows.append(run_prefix_share(
                cfg, params, max_len=max_len, page_size=page_size,
                fanout=fanout, prompt_len=3 * page_size + 5,
                max_new=max_new, share=share))

    # Replicated sweep: N engines on one CRDT page table, staggered
    # shared-prefix fan-out (gossip cost + cross-replica prefix reuse).
    repl_rows = []
    for replicas in ((2,) if quick else (2, 4)):
        repl_rows.append(run_replicated(
            cfg, params, replicas=replicas, batch=2, max_len=max_len,
            page_size=page_size, prompt_len=3 * page_size + 5,
            max_new=max_new))

    # Disaggregation sweep: prefill/decode roles over the CRDT page table,
    # physical page adoption ON vs OFF on the identical workload (see
    # run_disagg) — the coordination-vs-data-plane comparison.
    disagg_rows = []
    disagg_streams = {}
    for adopt in (False, True):
        row, streams = run_disagg(
            cfg, params, replicas=2, batch=2, max_len=max_len,
            page_size=page_size, prompt_len=3 * page_size + 5,
            max_new=max_new, adopt=adopt)
        disagg_rows.append(row)
        disagg_streams[adopt] = streams

    # Fault sweep: crash failover + load shedding on the real server over
    # seeded faulty gossip (deterministic counters; see run_fault_sweep).
    fault_rows = run_fault_sweep(
        cfg, params,
        schedules=("lossy",) if quick else ("lossy", "reorder_delay"),
        crash_ats=(4,) if quick else (4, 8))

    # Speculative-decoding sweep: off / prompt-lookup / CRDT-doc drafting
    # through the mixed step, plus an end-to-end agent trial (off vs doc).
    spec_rows = run_spec_decode(
        cfg, params, batch=batches[0], max_len=max_len, page_size=page_size,
        n_requests=batches[0] + 2, prompt_hi=prompt_hi // 2,
        max_new=2 * max_new, spec_k=4)
    spec_agent_rows = run_spec_agents(cfg, params, spec_k=4)

    # Quantized page-pool sweep on a dedicated head_dim=64 single-head
    # config: the capacity gain is head_dim-bound (scales amortize over the
    # feature axis — bf16→int8 gain is 2D/(D+4)), and the sim-llm's 16-wide
    # heads would cap it at 1.6× regardless of how good the layout is.
    qcfg = cfg.replace(num_heads=1, num_kv_heads=1, head_dim=64)
    qparams = lm.init(qcfg, seed=0, device=_device(params))
    quant_rows = run_quant_sweep(
        qcfg, qparams, batch=batches[0], max_len=max_len,
        page_size=page_size, n_requests=batches[0] + 2,
        prompt_hi=prompt_hi // 2, max_new=max_new)
    quant_err = quant_error_report(qcfg, qparams)

    # Tiered-memory sweep: host-swap preemption vs recompute on an
    # undersized pool (see run_swap_sweep).
    swap_rows = run_swap_sweep(cfg, params, swap_tier_pages=swap_tier_pages)

    ratios = []
    for d in rows:
        if d["mode"] != "dense":
            continue
        p = next(r for r in rows
                 if r["mode"] == "paged" and r["batch"] == d["batch"]
                 and r["skew"] == d["skew"])
        ratios.append(d["write_bytes_per_step"] / p["write_bytes_per_step"])
    stalled = next(r for r in chunk_rows if r["admission"] == "stalled")
    report = {
        "config": {"model": cfg.name, "d_model": cfg.d_model,
                   "num_layers": cfg.num_layers, "max_len": max_len,
                   "page_size": page_size, "quick": quick},
        "rows": rows,
        "chunked_admission": chunk_rows,
        "prefix_share": share_rows,
        "replicated": repl_rows,
        "fault": fault_rows,
        "fault_tolerance": {
            # Acceptance: every trial upholds the chaos invariants
            # (exactly-once, bitwise convergence, lane conservation), no
            # accepted request is ever lost, and every crash trial actually
            # exercised failover (recovered at least one orphan).
            "all_invariants_ok": all(r["ok"] for r in fault_rows),
            "no_lost_requests": all(r["lost"] == 0 for r in fault_rows),
            "crash_runs_recovered": all(
                r["recovered"] > 0 for r in fault_rows if r["crash_at"] >= 0),
        },
        "replication": {
            # Every replica pair landed bitwise-identical page tables after
            # the drain sync, and the fan-out workload produced at least one
            # cross-replica shared-prefix resolution per config.
            "all_converged": all(r["converged"] for r in repl_rows),
            "cross_replica_hits_positive": all(
                r["cross_replica_hits"] > 0 for r in repl_rows),
            "all_completed": all(r["completed"] == r["n_requests"]
                                 for r in repl_rows),
        },
        "disagg": disagg_rows,
        "disaggregation": {
            # Acceptance: adoption moved real pages and skipped real prefill
            # chunks, never made TTFT worse than the local-prefill baseline
            # on the identical workload, produced token streams identical
            # to it (transfers are bitwise), and the baseline run proves
            # the OFF switch truly never moved a byte.
            "adopted_pages_positive":
                disagg_rows[1]["adopted_pages"] > 0,
            "prefill_steps_avoided_positive":
                disagg_rows[1]["prefill_steps_avoided"] > 0,
            "ttft_adopt_not_worse": (disagg_rows[1]["ttft_steps_mean"]
                                     <= disagg_rows[0]["ttft_steps_mean"]),
            "streams_match": disagg_streams[True] == disagg_streams[False],
            "baseline_never_adopts": (
                disagg_rows[0]["adopted_pages"] == 0
                and disagg_rows[0]["transfer_bytes"] == 0),
            "all_completed": all(r["completed"] == r["n_requests"]
                                 for r in disagg_rows),
            "all_converged": all(r["converged"] for r in disagg_rows),
        },
        "spec_decode": {"engine": spec_rows, "agents": spec_agent_rows},
        "quant": quant_rows,
        "quant_error": quant_err,
        "swap": swap_rows,
        "quantization": {
            # Acceptance: int8 greedy streams are bit-identical to the
            # bf16-pool reference (fp8 is held only to the logit-error
            # budget — ~3 mantissa bits may flip near-tie argmaxes), one
            # cached token pins ≥1.8× fewer bytes (pool + scales, analytic
            # from the CacheSpec leaves), and each quant step reads fewer
            # bytes and pins fewer resident MB than bf16 paged.
            "streams_match_int8": all(
                r["streams_match"] for r in quant_rows
                if r["kv_quant"] != "fp8"),
            "resident_capacity_gain_ok": all(
                r["resident_capacity_gain"] >= 1.8 for r in quant_rows
                if r["kv_quant"] != "off"),
            "read_bytes_below_fp32": all(
                r["read_bytes_per_step"] < quant_rows[0][
                    "read_bytes_per_step"]
                for r in quant_rows if r["kv_quant"] != "off"),
            "resident_mb_below_fp32": all(
                r["resident_cache_mb"] < quant_rows[0]["resident_cache_mb"]
                for r in quant_rows if r["kv_quant"] != "off"),
            "greedy_match_int8": quant_err["greedy_match_int8"],
            "error_within_tol": quant_err["all_within_tol"],
        },
        "memory_tiers": {
            # Acceptance: the swap tier recovers the preempted long-context
            # victim in strictly fewer steps than recompute-from-scratch,
            # with identical token streams, and its counters prove pages
            # actually moved through the host tier (while the recompute
            # reference never swapped).
            "swap_beats_recompute": (
                swap_rows[1]["steps"] < swap_rows[0]["steps"]),
            "streams_match": all(r["streams_match"] for r in swap_rows),
            "swap_counters_positive": (
                swap_rows[1]["swap_outs"] > 0
                and swap_rows[1]["swap_ins"] > 0
                and swap_rows[1]["preempt_swap"] > 0),
            "recompute_reference_unswapped": (
                swap_rows[0]["swap_outs"] == 0
                and swap_rows[0]["preempt_swap"] == 0),
            "all_completed": all(r["completed"] == 2 for r in swap_rows),
        },
        "speculation": {
            # Acceptance: every speculative engine run reproduces the
            # greedy reference streams token-for-token, drafts something
            # (accept_rate > 0), and the e2e agent trial matches the
            # baseline document digest while finishing in fewer steps.
            "streams_match": all(r["streams_match"] for r in spec_rows),
            "accept_rate_positive": all(
                r["accept_rate"] > 0 for r in spec_rows
                if r["spec"] != "off"),
            "agents_digest_match": all(
                r["digest_match"] for r in spec_agent_rows),
            "agents_steps_reduced": all(
                r["steps"] < spec_agent_rows[0]["steps"]
                for r in spec_agent_rows if r["spec"] != "off"),
        },
        "write_bytes_ratio_dense_over_paged": min(ratios),
        "admission": {
            "mid_flight_admissions": sum(r["admitted_mid_flight"]
                                         for r in rows if r["mode"] == "paged"),
            "all_completed": all(r["completed"] == r["n_requests"]
                                 for r in rows),
            # Acceptance headline: every chunked config stalls strictly
            # fewer decode steps than the bucketed-admission baseline.
            "chunked_stalls_below_baseline": all(
                r["decode_stall_steps"] < stalled["decode_stall_steps"]
                for r in chunk_rows if r["admission"] == "chunked"),
        },
    }
    Path(out).write_text(json.dumps(report, indent=2))
    # Quant-error report doubles as a standalone CI artifact next to the
    # main report (uploaded by the bench-smoke job).
    Path(out).with_name(QUANT_OUT).write_text(
        json.dumps(quant_err, indent=2))
    for r in rows:
        name = f"serving/{r['mode']}_b{r['batch']}_{r['skew']}"
        derived = (f"writeB/step={r['write_bytes_per_step']}"
                   f";readB/step={r['read_bytes_per_step']}"
                   f";residentMB={r['resident_cache_mb']:.2f}")
        emit_csv(f"{name},{r['us_per_token']:.1f},{derived}")
    emit_csv(f"serving/write_ratio,0.0,dense_over_paged="
             f"{report['write_bytes_ratio_dense_over_paged']:.1f}x")
    for r in chunk_rows:
        name = (f"serving/admit_{r['admission']}"
                + (f"_c{r['chunk_size']}" if r["admission"] == "chunked"
                   else ""))
        derived = (f"stallSteps={r['decode_stall_steps']}"
                   f";ttftSteps={r['ttft_steps_mean']:.1f}"
                   f";itlP50us={r['itl_p50_us']:.0f}"
                   f";itlP99us={r['itl_p99_us']:.0f}")
        emit_csv(f"{name},{r['us_per_step']:.1f},{derived}")
    for r in share_rows:
        name = (f"serving/prefix_f{r['fanout']}_"
                f"{'cow' if r['cow'] else 'nocow'}")
        derived = (f"residentMB={r['resident_cache_mb']:.2f}"
                   f";sharedPages={r['shared_pages']}"
                   f";cowCopies={r['cow_copies']}")
        emit_csv(f"{name},{r['admission_us']:.1f},{derived}")
    for r in repl_rows:
        derived = (f"syncB/step={r['sync_bytes_per_step']}"
                   f";xReplicaHits={r['cross_replica_hits']}"
                   f";publishedPages={r['published_prefix_pages']}"
                   f";converged={int(r['converged'])}")
        emit_csv(f"serving/repl_r{r['replicas']},{r['us_per_step']:.1f},"
                 f"{derived}")
    for r in disagg_rows:
        derived = (f"adoptedPages={r['adopted_pages']}"
                   f";prefillStepsAvoided={r['prefill_steps_avoided']}"
                   f";xferB/step={r['transfer_bytes_per_step']}"
                   f";ttftSteps={r['ttft_steps_mean']:.1f}"
                   f";aborts={r['adopt_aborts']}"
                   f";converged={int(r['converged'])}")
        emit_csv(f"serving/disagg_{r['adoption']},{r['us_per_step']:.1f},"
                 f"{derived}")
    for r in fault_rows:
        name = (f"serving/fault_{r['schedule']}"
                + ("_clean" if r["crash_at"] < 0 else f"_c{r['crash_at']}"))
        derived = (f"recovered={r['recovered']};retried={r['retried']}"
                   f";shed={r['shed']};lost={r['lost']}"
                   f";overheadSteps={r['recovery_step_overhead']}"
                   f";goodput={r['goodput_tokens_per_step']:.3f}"
                   f";ok={int(r['ok'])}")
        emit_csv(f"{name},0.0,{derived}")
    for r in spec_rows:
        derived = (f"acceptRate={r['accept_rate']:.2f}"
                   f";tokPerStep={r['tokens_per_step']:.2f}"
                   f";usPerAccTok={r['us_per_accepted_token']:.1f}"
                   f";draft={r['draft_tokens']};roll={r['rollback_tokens']}"
                   f";steps={r['steps']};match={int(r['streams_match'])}")
        emit_csv(f"serving/spec_{r['spec']},{r['us_per_step']:.1f},{derived}")
    for r in spec_agent_rows:
        derived = (f"steps={r['steps']};acceptRate={r['accept_rate']:.2f}"
                   f";roll={r['rollback_tokens']}"
                   f";digestMatch={int(r['digest_match'])}")
        emit_csv(f"serving/spec_agents_{r['spec']},"
                 f"{1e6 * r['wall_s']:.0f},{derived}")
    for r in quant_rows:
        derived = (f"readB/step={r['read_bytes_per_step']}"
                   f";residentMB={r['resident_cache_mb']:.3f}"
                   f";slotB={r['slot_bytes']}"
                   f";capGain={r['resident_capacity_gain']:.2f}"
                   f";match={int(r['streams_match'])}")
        emit_csv(f"serving/quant_{r['kv_quant']},"
                 f"{r['us_per_token']:.1f},{derived}")
    for mode, e in quant_err["modes"].items():
        emit_csv(f"serving/quant_err_{mode},0.0,"
                 f"mse={e['logit_mse']:.2e}"
                 f";maxAbs={e['logit_max_abs']:.4f}"
                 f";greedy={int(e['greedy_match'])}"
                 f";withinTol={int(e['within_tol'])}")
    for r in swap_rows:
        derived = (f"steps={r['steps']};swapOuts={r['swap_outs']}"
                   f";swapIns={r['swap_ins']}"
                   f";preemptSwap={r['preempt_swap']}"
                   f";preemptRecompute={r['preempt_recompute']}"
                   f";match={int(r['streams_match'])}")
        emit_csv(f"serving/swap_{r['tier']},{r['us_per_step']:.1f},{derived}")
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--swap-tier-pages", type=int, default=8,
                    help="host swap-pool slots for the memory-tier sweep "
                         "(0 disables the swap row's tier)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    run_bench(quick=args.quick, out=args.out,
              swap_tier_pages=args.swap_tier_pages, device=args.device)


if __name__ == "__main__":
    main()
