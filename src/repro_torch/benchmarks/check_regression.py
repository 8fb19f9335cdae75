"""CI gate: fail when the serving benchmark's paged path regresses more
than ``--max-regression`` (default 15%) against the checked-in baseline
(the port's copy of the JAX package's ``benchmarks/check_regression.py``:
the same counters, thresholds and table; pure Python).

Only paged rows are gated, keyed by (batch, skew), on two signal classes:

* **Deterministic counters** — analytic write/read bytes per step, resident
  cache MB, peak pages.  These are pure functions of the code (bit-identical
  across reruns of the same commit), so they get the strict
  ``--max-regression`` threshold: any increase past it is a real paged-path
  regression (more bytes touched per step, more resident memory), never
  runner noise.
The replicated sweep (N engines on one CRDT page table) is gated the same
way: anti-entropy sync bytes and step counts are deterministic counters,
plus boolean acceptance flags (bitwise replica convergence, cross-replica
shared-prefix hits > 0, all requests completed).  The speculative-decoding
sweep gates waste counters (steps, draft/rollback tokens) against a strict
ceiling, acceptance counters (accept_rate, accepted_tokens, tokens/step)
against a strict floor, µs/accepted-token normalized by the same run's
non-speculative row, and the stream-identity / digest-match flags.  The
quantized page-pool sweep ceiling-gates analytic traffic, floor-gates the
resident-capacity gain (>=1.8x is an acceptance flag), and checks the int8
greedy-identity + logit-error-budget flags; the tiered-memory sweep gates
the swap counters both ways (an increase is thrashing, a decrease means
the tier quietly disengaged) plus the swap-beats-recompute flags.  The
disaggregation sweep ceiling-gates transfer traffic / aborts / TTFT,
floor-gates adopted pages and avoided prefill steps, and checks the
adoption acceptance flags (TTFT-with <= TTFT-without, bitwise stream
identity against local prefill, coordination-only baseline moved zero
bytes).  A
gated counter missing from either report is a loud failure, and the run
ends with a one-line-per-counter pass/fail table.

* **Wall clock** — µs/token normalized by the *same run's* dense row at the
  same key (which cancels the runner-speed term; absolute interpret-mode
  timings are machine-dependent).  Tiny CPU benches still jitter ±20% on
  the ratio, so timing gets the looser ``--timing-slack`` (default 50%) —
  wide enough to ignore dispatch jitter, tight enough to catch an
  accidentally-quadratic paged step.  A report missing its dense row falls
  back to absolute µs/token for that key.

Both files are outputs of the port's ``bench_serving`` at matching
--quick settings.  The default baseline is the port's own, written on the
CPU (``bench_serving --quick --device cpu``, under ``PYTHONHASHSEED=0``:
the agent trial's prompts seed from ``hash``):

  PYTHONPATH=src python -m repro_torch.benchmarks.check_regression \
      [--baseline src/repro_torch/benchmarks/baselines/BENCH_serving_quick.json] \
      --current BENCH_serving_torch.json --max-regression 0.15
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BASELINE = Path(__file__).resolve().parent / "baselines" / \
    "BENCH_serving_quick.json"

COUNTERS = ("write_bytes_per_step", "read_bytes_per_step",
            "resident_cache_mb", "peak_pages")

# Chunked-admission sweep counters: greedy decoding at fixed seeds makes
# step counts, stall counts and TTFT-in-steps bit-identical across reruns
# of the same commit, so they get the strict threshold too.
CHUNK_COUNTERS = ("steps", "decode_stall_steps", "stalled_lane_steps",
                  "ttft_steps_mean", "peak_pages")

# Replicated sweep counters: the gossip schedule is reliable and in-order
# and decoding is greedy, so anti-entropy wire bytes and step counts are
# bit-identical across reruns of the same commit (the suite asserts this).
# An increase past the strict threshold means the sync protocol started
# shipping more metadata per step — a real coordination-cost regression.
REPL_COUNTERS = ("sync_bytes_per_step", "sync_bytes", "steps")

# Fault sweep counters: the chaos harness decodes greedily over a seeded
# channel, so recovery cost and shedding volume are bit-identical across
# reruns of the same commit.  An increase past the strict threshold means
# failover got slower (more overhead steps to re-complete orphans) or the
# runtime started dropping more work (shed/failed/lost) — both real
# robustness regressions.
FAULT_COUNTERS = ("steps", "recovery_step_overhead", "recovered", "retried",
                  "shed", "lost", "failed")

# Speculative-decoding sweep counters: drafting is a pure function of the
# (seeded) token streams and verification is greedy, so every counter is
# bit-identical across reruns of the same commit.  Counters where an
# INCREASE is a regression (more steps, more wasted drafts) get the strict
# ceiling gate; counters where a DECREASE is a regression (acceptance
# collapsed, throughput-per-step dropped) get the strict floor gate.
SPEC_COUNTERS = ("steps", "draft_tokens", "rollback_tokens")
SPEC_FLOOR_COUNTERS = ("accept_rate", "accepted_tokens", "tokens_per_step")
SPEC_AGENT_COUNTERS = ("steps", "rollback_tokens")
SPEC_AGENT_FLOOR_COUNTERS = ("accept_rate", "accepted_tokens")

# Quantized page-pool sweep counters: analytic bytes / slot sizes are pure
# functions of the CacheSpec leaves and decoding is greedy, so every
# counter is bit-identical across reruns.  Ceiling-gate the traffic and
# step counters; floor-gate ``resident_capacity_gain`` (a drop means the
# quant layout got fatter — wider scales or payload) and the completion
# counters.
QUANT_COUNTERS = ("write_bytes_per_step", "read_bytes_per_step",
                  "slot_bytes", "steps")
QUANT_FLOOR_COUNTERS = ("resident_capacity_gain", "gen_tokens", "completed")

# Tiered-memory sweep counters: the preemption schedule is deterministic
# (greedy decode, fixed seeds), so swap traffic is bit-identical across
# reruns.  ``steps`` / ``preempt_recompute`` are waste (ceiling);
# ``completed`` / ``gen_tokens`` are floors; the swap-tier counters are
# gated BOTH ways — an increase is thrashing, a decrease means the tier
# quietly disengaged.
SWAP_COUNTERS = ("steps", "preempt_recompute")
SWAP_FLOOR_COUNTERS = ("completed", "gen_tokens")
SWAP_BIDIR_COUNTERS = ("swap_outs", "swap_ins", "preempt_swap")

# Disaggregation sweep counters: role-aware routing, greedy decode and a
# seeded arrival schedule make every adoption counter bit-identical across
# reruns of the same commit.  Ceiling-gate the transfer traffic and waste
# (more bytes shipped per step means the page-transfer path got fatter;
# more aborts means the epoch check started losing races), the step count
# and TTFT-in-steps; floor-gate the adoption wins (fewer adopted pages or
# avoided prefill steps means the cross-replica path quietly disengaged)
# and the completion counters.
DISAGG_COUNTERS = ("steps", "transfer_bytes", "transfer_bytes_per_step",
                   "adopt_aborts", "ttft_steps_mean")
DISAGG_FLOOR_COUNTERS = ("adopted_pages", "prefill_steps_avoided",
                         "completed", "gen_tokens")


def rows_by_key(report: dict, mode: str) -> dict[tuple, dict]:
    return {(r["batch"], r["skew"]): r
            for r in report["rows"] if r["mode"] == mode}


def chunk_rows_by_key(report: dict) -> dict[tuple, dict]:
    return {(r["admission"], r.get("chunk_size", 0)): r
            for r in report.get("chunked_admission", [])}


def repl_rows_by_key(report: dict) -> dict[tuple, dict]:
    return {(r["replicas"],): r for r in report.get("replicated", [])}


def fault_rows_by_key(report: dict) -> dict[tuple, dict]:
    return {(r["schedule"], r["crash_at"]): r
            for r in report.get("fault", [])}


def spec_rows_by_key(report: dict) -> dict[tuple, dict]:
    return {(r["spec"],): r
            for r in report.get("spec_decode", {}).get("engine", [])}


def spec_agent_rows_by_key(report: dict) -> dict[tuple, dict]:
    return {(r["spec"],): r
            for r in report.get("spec_decode", {}).get("agents", [])}


def quant_rows_by_key(report: dict) -> dict[tuple, dict]:
    return {(r["kv_quant"],): r for r in report.get("quant", [])}


def swap_rows_by_key(report: dict) -> dict[tuple, dict]:
    return {(r["tier"],): r for r in report.get("swap", [])}


def disagg_rows_by_key(report: dict) -> dict[tuple, dict]:
    return {(r["adoption"],): r for r in report.get("disagg", [])}


def timing_value(report: dict, key: tuple) -> tuple[float, str]:
    """Dense-normalized paged µs/token (absolute when dense row missing)."""
    paged = rows_by_key(report, "paged")[key]
    dense = rows_by_key(report, "dense").get(key)
    if dense is not None and dense["us_per_token"] > 0:
        return paged["us_per_token"] / dense["us_per_token"], "paged/dense"
    return paged["us_per_token"], "us/tok"


def check(baseline: dict, current: dict, max_regression: float,
          timing_slack: float) -> tuple[bool, list[str]]:
    base = rows_by_key(baseline, "paged")
    cur = rows_by_key(current, "paged")
    ok = True
    lines = []
    # Per-counter tally for the summary table: name -> [ok, fail, missing].
    tally: dict[str, list[int]] = {}

    def _tally(name, kind):
        tally.setdefault(name, [0, 0, 0])[kind] += 1

    def judge(label, name, bval, cval, limit, floor=False):
        nonlocal ok
        ratio = cval / max(bval, 1e-9) - 1.0
        if floor:     # a DECREASE past the limit is the regression
            bad = -ratio > limit and bval - cval > 1e-9
        else:
            bad = ratio > limit and cval - bval > 1e-9
        if bad:
            ok = False
        _tally(name, 1 if bad else 0)
        lines.append(
            f"{label:>16} {name:>18}: baseline "
            f"{bval:12.3f}, current {cval:12.3f} ({ratio:+.1%}) "
            f"{'FAIL' if bad else 'ok'}")

    def counter(label, name, brow, crow, limit, floor=False):
        """Judge one gated counter, failing LOUDLY when either report is
        missing it (a silently absent counter would otherwise let a broken
        bench ship)."""
        nonlocal ok
        missing = [w for w, row in (("baseline", brow), ("current", crow))
                   if name not in row]
        if missing:
            ok = False
            _tally(name, 2)
            lines.append(f"{label:>16} {name:>18}: MISSING in "
                         f"{' and '.join(missing)} report FAIL")
            return
        judge(label, name, float(brow[name]), float(crow[name]), limit,
              floor=floor)

    for key in sorted(base):
        if key not in cur:
            ok = False
            lines.append(f"MISSING paged row {key} in current run")
            continue
        label = f"paged b{key[0]} {key[1]}"
        for name in COUNTERS:
            counter(label, name, base[key], cur[key], max_regression)
        bval, bkind = timing_value(baseline, key)
        cval, ckind = timing_value(current, key)
        if bkind != ckind:          # one report lacks its dense row
            bval = base[key]["us_per_token"]
            cval = cur[key]["us_per_token"]
            bkind = "us/tok"
        judge(label, bkind, bval, cval, timing_slack)

    cbase = chunk_rows_by_key(baseline)
    ccur = chunk_rows_by_key(current)
    for key in sorted(cbase):
        if key not in ccur:
            ok = False
            lines.append(f"MISSING chunked-admission row {key} in current "
                         "run")
            continue
        for name in CHUNK_COUNTERS:
            counter(f"{key[0]} c{key[1]}", name, cbase[key], ccur[key],
                    max_regression)
    if cbase and "chunked_admission" in current:
        stalls_ok = current.get("admission", {}).get(
            "chunked_stalls_below_baseline", False)
        lines.append(f"chunked stalls < stalled baseline: "
                     f"{'ok' if stalls_ok else 'FAIL'}")
        ok = ok and stalls_ok

    rbase = repl_rows_by_key(baseline)
    rcur = repl_rows_by_key(current)
    for key in sorted(rbase):
        if key not in rcur:
            ok = False
            lines.append(f"MISSING replicated row {key} in current run")
            continue
        for name in REPL_COUNTERS:
            counter(f"repl r{key[0]}", name, rbase[key], rcur[key],
                    max_regression)
    if rbase and "replicated" in current:
        for flag, desc in (("all_converged",
                            "replicas bitwise converged"),
                           ("cross_replica_hits_positive",
                            "cross-replica shared-prefix hits > 0"),
                           ("all_completed",
                            "replicated sweep completed all requests")):
            flag_ok = current.get("replication", {}).get(flag, False)
            lines.append(f"{desc}: {'ok' if flag_ok else 'FAIL'}")
            ok = ok and flag_ok

    fbase = fault_rows_by_key(baseline)
    fcur = fault_rows_by_key(current)
    for key in sorted(fbase):
        if key not in fcur:
            ok = False
            lines.append(f"MISSING fault row {key} in current run")
            continue
        label = (f"fault {key[0]}"
                 + (" clean" if key[1] < 0 else f" c{key[1]}"))
        for name in FAULT_COUNTERS:
            counter(label, name, fbase[key], fcur[key], max_regression)
    if fbase and "fault" in current:
        for flag, desc in (("all_invariants_ok",
                            "chaos invariants (exactly-once, convergence, "
                            "lane conservation) hold"),
                           ("no_lost_requests",
                            "no accepted request lost across failover"),
                           ("crash_runs_recovered",
                            "every crash trial recovered orphans")):
            flag_ok = current.get("fault_tolerance", {}).get(flag, False)
            lines.append(f"{desc}: {'ok' if flag_ok else 'FAIL'}")
            ok = ok and flag_ok

    # Speculative-decoding sweep: ceiling-gate waste counters, floor-gate
    # acceptance, and gate µs/accepted-token normalized by the SAME run's
    # non-speculative row (cancels the runner-speed term, like paged/dense).
    sbase = spec_rows_by_key(baseline)
    scur = spec_rows_by_key(current)
    for key in sorted(sbase):
        if key not in scur:
            ok = False
            lines.append(f"MISSING spec-decode row {key} in current run")
            continue
        label = f"spec {key[0]}"
        for name in SPEC_COUNTERS:
            counter(label, name, sbase[key], scur[key], max_regression)
        for name in SPEC_FLOOR_COUNTERS:
            counter(label, name, sbase[key], scur[key], max_regression,
                    floor=True)
        boff, coff = sbase.get(("off",)), scur.get(("off",))
        if key != ("off",) and boff and coff:
            bval = (sbase[key]["us_per_accepted_token"]
                    / max(boff["us_per_accepted_token"], 1e-9))
            cval = (scur[key]["us_per_accepted_token"]
                    / max(coff["us_per_accepted_token"], 1e-9))
            judge(label, "usAccTok/off", bval, cval, timing_slack)
    abase = spec_agent_rows_by_key(baseline)
    acur = spec_agent_rows_by_key(current)
    for key in sorted(abase):
        if key not in acur:
            ok = False
            lines.append(f"MISSING spec-agent row {key} in current run")
            continue
        label = f"spec-agents {key[0]}"
        for name in SPEC_AGENT_COUNTERS:
            counter(label, name, abase[key], acur[key], max_regression)
        if key != ("off",):
            for name in SPEC_AGENT_FLOOR_COUNTERS:
                counter(label, name, abase[key], acur[key], max_regression,
                        floor=True)
    if sbase and "spec_decode" in current:
        for flag, desc in (("streams_match",
                            "speculative streams token-identical to greedy"),
                           ("accept_rate_positive",
                            "every drafter accepted > 0 tokens"),
                           ("agents_digest_match",
                            "agent-trial document digest matches baseline"),
                           ("agents_steps_reduced",
                            "speculative agent trial used fewer steps")):
            flag_ok = current.get("speculation", {}).get(flag, False)
            lines.append(f"{desc}: {'ok' if flag_ok else 'FAIL'}")
            ok = ok and flag_ok

    # Quantized page-pool sweep: ceiling-gate traffic, floor-gate the
    # resident-capacity gain, and gate µs/token normalized by the SAME
    # run's kv_quant=off row (cancels the runner-speed term).
    qbase = quant_rows_by_key(baseline)
    qcur = quant_rows_by_key(current)
    for key in sorted(qbase):
        if key not in qcur:
            ok = False
            lines.append(f"MISSING quant row {key} in current run")
            continue
        label = f"quant {key[0]}"
        for name in QUANT_COUNTERS:
            counter(label, name, qbase[key], qcur[key], max_regression)
        for name in QUANT_FLOOR_COUNTERS:
            counter(label, name, qbase[key], qcur[key], max_regression,
                    floor=True)
        boff, coff = qbase.get(("off",)), qcur.get(("off",))
        if key != ("off",) and boff and coff:
            bval = (qbase[key]["us_per_token"]
                    / max(boff["us_per_token"], 1e-9))
            cval = (qcur[key]["us_per_token"]
                    / max(coff["us_per_token"], 1e-9))
            judge(label, "usTok/off", bval, cval, timing_slack)
    if qbase and "quant" in current:
        for flag, desc in (("streams_match_int8",
                            "int8 greedy streams identical to bf16 pools"),
                           ("resident_capacity_gain_ok",
                            "quant slot pins >= 1.8x fewer bytes"),
                           ("read_bytes_below_fp32",
                            "quant step reads fewer bytes than bf16 paged"),
                           ("resident_mb_below_fp32",
                            "quant run pins fewer resident MB"),
                           ("greedy_match_int8",
                            "int8 teacher-forced argmax matches reference"),
                           ("error_within_tol",
                            "quant logit error inside documented budget")):
            flag_ok = current.get("quantization", {}).get(flag, False)
            lines.append(f"{desc}: {'ok' if flag_ok else 'FAIL'}")
            ok = ok and flag_ok

    # Tiered-memory sweep: swap-tier counters are gated both ways (see the
    # SWAP_* comment) plus the swap-beats-recompute acceptance flags.
    wbase = swap_rows_by_key(baseline)
    wcur = swap_rows_by_key(current)
    for key in sorted(wbase):
        if key not in wcur:
            ok = False
            lines.append(f"MISSING swap row {key} in current run")
            continue
        label = f"swap {key[0]}"
        for name in SWAP_COUNTERS:
            counter(label, name, wbase[key], wcur[key], max_regression)
        for name in SWAP_FLOOR_COUNTERS:
            counter(label, name, wbase[key], wcur[key], max_regression,
                    floor=True)
        for name in SWAP_BIDIR_COUNTERS:
            counter(label, name, wbase[key], wcur[key], max_regression)
            counter(label, name, wbase[key], wcur[key], max_regression,
                    floor=True)
    if wbase and "swap" in current:
        for flag, desc in (("swap_beats_recompute",
                            "swap re-admission uses fewer steps than "
                            "recompute"),
                           ("streams_match",
                            "swap/recompute token streams identical"),
                           ("swap_counters_positive",
                            "swap tier actually engaged (outs/ins/preempts "
                            "> 0)"),
                           ("recompute_reference_unswapped",
                            "recompute reference never swapped"),
                           ("all_completed",
                            "memory-tier sweep completed all requests")):
            flag_ok = current.get("memory_tiers", {}).get(flag, False)
            lines.append(f"{desc}: {'ok' if flag_ok else 'FAIL'}")
            ok = ok and flag_ok

    # Disaggregation sweep: ceiling-gate the transfer traffic and TTFT,
    # floor-gate the adoption wins, and check the acceptance flags — the
    # adoption-on row must beat (or tie) the coordination-only row on TTFT
    # while producing bitwise-identical token streams.
    dbase = disagg_rows_by_key(baseline)
    dcur = disagg_rows_by_key(current)
    for key in sorted(dbase):
        if key not in dcur:
            ok = False
            lines.append(f"MISSING disagg row {key} in current run")
            continue
        label = f"disagg {key[0]}"
        for name in DISAGG_COUNTERS:
            counter(label, name, dbase[key], dcur[key], max_regression)
        for name in DISAGG_FLOOR_COUNTERS:
            counter(label, name, dbase[key], dcur[key], max_regression,
                    floor=True)
    if dbase and "disagg" in current:
        for flag, desc in (("adopted_pages_positive",
                            "decode tier adopted > 0 published pages"),
                           ("prefill_steps_avoided_positive",
                            "adoption avoided > 0 prefill steps"),
                           ("ttft_adopt_not_worse",
                            "TTFT with adoption <= TTFT without"),
                           ("streams_match",
                            "adoption streams token-identical to local "
                            "prefill"),
                           ("baseline_never_adopts",
                            "adoption-off row moved zero pages/bytes"),
                           ("all_completed",
                            "disagg sweep completed all requests"),
                           ("all_converged",
                            "disagg replicas bitwise converged")):
            flag_ok = current.get("disaggregation", {}).get(flag, False)
            lines.append(f"{desc}: {'ok' if flag_ok else 'FAIL'}")
            ok = ok and flag_ok

    # One line per gated counter: how many keys passed / failed / were
    # missing, so a red run names the offending counter at a glance.
    lines.append("per-counter gate table:")
    for name, (n_ok, n_fail, n_miss) in tally.items():
        status = "FAIL" if (n_fail or n_miss) else "ok"
        lines.append(f"{name:>24}: {n_ok} ok, {n_fail} fail, "
                     f"{n_miss} missing  {status}")
    return ok, lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", default=str(BASELINE))
    ap.add_argument("--current", default="BENCH_serving_torch.json")
    ap.add_argument("--max-regression", type=float, default=0.15,
                    help="threshold for deterministic per-step counters")
    ap.add_argument("--timing-slack", type=float, default=0.50,
                    help="threshold for the dense-normalized timing ratio")
    args = ap.parse_args(argv)

    baseline = json.loads(Path(args.baseline).read_text())
    current = json.loads(Path(args.current).read_text())
    ok, lines = check(baseline, current, args.max_regression,
                      args.timing_slack)
    for line in lines:
        print(line)
    if not ok:
        print("REGRESSION: paged path exceeded baseline "
              f"(counters >{args.max_regression:.0%} or timing "
              f">{args.timing_slack:.0%})")
        sys.exit(1)
    print("serving regression gate passed")


if __name__ == "__main__":
    main()
