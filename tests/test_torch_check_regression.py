"""The port's serving regression gate against the JAX package's, on
synthetic report pairs built in memory (no baseline file is read).

``repro_torch.benchmarks.check_regression`` is a copy of JAX's pure-Python
``benchmarks/check_regression.py``: for every pair — equal reports, a
gated counter pushed past its threshold in each sweep, a floor counter
dropped, a bidirectional counter moved either way, a missing counter, a
missing dense or paged row, a false acceptance flag, a timing ratio past
its slack — its verdict and its whole table must equal JAX's ``check``.
Last, ``chip_smoke.py``'s card-side reading of the same gate: which failed
lines it keeps apart as token-dependent, and its int8 tie rule.
"""
from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from benchmarks import check_regression as jcheck  # noqa: E402
from repro_torch.benchmarks import check_regression as tcheck  # noqa: E402

MAX_REG, SLACK = 0.15, 0.50


def _report() -> dict:
    """A report with every sweep and flag section of ``bench_serving``."""
    rows = []
    for batch in (4, 8):
        for skew in ("uniform", "ragged"):
            for mode, wb in (("dense", 262144), ("paged", 2048)):
                rows.append(dict(batch=batch, skew=skew, mode=mode,
                                 write_bytes_per_step=wb * batch,
                                 read_bytes_per_step=147456 * batch,
                                 resident_cache_mb=0.25, peak_pages=9,
                                 us_per_token=700.0 if mode == "dense"
                                 else 900.0,
                                 completed=10, n_requests=10))
    chunk = [dict(admission="stalled", chunk_size=128, steps=40,
                  decode_stall_steps=6, stalled_lane_steps=12,
                  ttft_steps_mean=1.0, peak_pages=9)]
    chunk += [dict(admission="chunked", chunk_size=c, steps=44,
                   decode_stall_steps=0, stalled_lane_steps=0,
                   ttft_steps_mean=2.5, peak_pages=9) for c in (16, 32)]
    repl = [dict(replicas=r, sync_bytes_per_step=12898, sync_bytes=400000,
                 steps=31) for r in (2, 4)]
    fault = [dict(schedule="lossy", crash_at=c, steps=26 + max(c, 0),
                  recovery_step_overhead=max(c, 0), recovered=3 * (c > 0),
                  retried=3 * (c > 0), shed=0, lost=0, failed=0)
             for c in (-1, 4)]
    spec = [dict(spec=s, steps=st, draft_tokens=d, rollback_tokens=rb,
                 accept_rate=ar, accepted_tokens=at, tokens_per_step=tps,
                 us_per_accepted_token=us)
            for s, st, d, rb, ar, at, tps, us in (
                ("off", 38, 0, 0, 0.0, 0, 2.5, 650.0),
                ("ngram", 27, 41, 5, 0.88, 36, 3.6, 800.0),
                ("doc", 18, 71, 17, 0.76, 54, 5.3, 950.0))]
    agents = [dict(spec="off", steps=456, rollback_tokens=0,
                   accept_rate=0.0, accepted_tokens=0),
              dict(spec="doc", steps=294, rollback_tokens=113,
                   accept_rate=0.59, accepted_tokens=162)]
    quant = [dict(kv_quant=q, write_bytes_per_step=w, read_bytes_per_step=r,
                  slot_bytes=s, steps=18, resident_capacity_gain=g,
                  gen_tokens=48, completed=6, us_per_token=us)
             for q, w, r, s, g, us in (
                 ("off", 2048, 49152, 512, 1.0, 600.0),
                 ("int8", 1088, 26112, 272, 1.88, 700.0),
                 ("fp8", 1088, 26112, 272, 1.88, 710.0))]
    swap = [dict(tier=t, steps=s, preempt_recompute=pr, completed=2,
                 gen_tokens=32, swap_outs=so, swap_ins=so, preempt_swap=ps)
            for t, s, pr, so, ps in (("recompute", 28, 4, 0, 0),
                                     ("swap", 23, 0, 2, 1))]
    disagg = [dict(adoption=a, steps=st, transfer_bytes=tb,
                   transfer_bytes_per_step=tb // st, adopt_aborts=0,
                   ttft_steps_mean=tt, adopted_pages=ap,
                   prefill_steps_avoided=pa, completed=8, gen_tokens=64)
              for a, st, tb, tt, ap, pa in (("off", 30, 0, 4.0, 0, 0),
                                            ("on", 28, 22320, 3.2, 3, 6))]
    return {
        "rows": rows, "chunked_admission": chunk,
        "admission": {"chunked_stalls_below_baseline": True,
                      "all_completed": True, "mid_flight_admissions": 12},
        "replicated": repl,
        "replication": {"all_converged": True,
                        "cross_replica_hits_positive": True,
                        "all_completed": True},
        "fault": fault,
        "fault_tolerance": {"all_invariants_ok": True,
                            "no_lost_requests": True,
                            "crash_runs_recovered": True},
        "spec_decode": {"engine": spec, "agents": agents},
        "speculation": {"streams_match": True, "accept_rate_positive": True,
                        "agents_digest_match": True,
                        "agents_steps_reduced": True},
        "quant": quant,
        "quantization": {"streams_match_int8": True,
                         "resident_capacity_gain_ok": True,
                         "read_bytes_below_fp32": True,
                         "resident_mb_below_fp32": True,
                         "greedy_match_int8": True,
                         "error_within_tol": True},
        "swap": swap,
        "memory_tiers": {"swap_beats_recompute": True,
                         "streams_match": True,
                         "swap_counters_positive": True,
                         "recompute_reference_unswapped": True,
                         "all_completed": True},
        "disagg": disagg,
        "disaggregation": {"adopted_pages_positive": True,
                           "prefill_steps_avoided_positive": True,
                           "ttft_adopt_not_worse": True,
                           "streams_match": True,
                           "baseline_never_adopts": True,
                           "all_completed": True, "all_converged": True},
    }


def _row(report, section, **key):
    rows = (report["spec_decode"][section.split("/")[1]]
            if section.startswith("spec_decode/") else report[section])
    return next(r for r in rows if all(r[k] == v for k, v in key.items()))


def _scale(section, key, name, factor):
    def edit(b, c):
        _row(c, section, **key)[name] *= factor
    return edit


def _flag(section, name):
    def edit(b, c):
        c[section][name] = False
    return edit


def _drop(which, section, key, name):
    def edit(b, c):
        del _row(b if which == "baseline" else c, section, **key)[name]
    return edit


def _drop_row(mode):
    def edit(b, c):
        c["rows"] = [r for r in c["rows"]
                     if not (r["mode"] == mode and r["batch"] == 8
                             and r["skew"] == "ragged")]
    return edit


PAGED = dict(mode="paged", batch=4, skew="ragged")
EDITS = {
    "equal": (lambda b, c: None, True),
    # A gated counter pushed past the strict threshold, in each sweep.
    "paged_write_bytes": (_scale("rows", PAGED, "write_bytes_per_step",
                                 1.2), False),
    "paged_write_bytes_inside": (_scale("rows", PAGED,
                                        "write_bytes_per_step", 1.1), True),
    "paged_timing": (_scale("rows", PAGED, "us_per_token", 1.6), False),
    "paged_timing_inside_slack": (_scale("rows", PAGED, "us_per_token",
                                         1.4), True),
    "chunk_stall_steps": (_scale("chunked_admission",
                                 dict(admission="chunked", chunk_size=16),
                                 "steps", 1.5), False),
    "repl_sync_bytes": (_scale("replicated", dict(replicas=2),
                               "sync_bytes_per_step", 1.3), False),
    "fault_retried": (_scale("fault", dict(crash_at=4), "retried", 2),
                      False),
    "spec_draft_tokens": (_scale("spec_decode/engine", dict(spec="doc"),
                                 "draft_tokens", 1.5), False),
    "spec_us_per_accepted_token": (_scale("spec_decode/engine",
                                          dict(spec="ngram"),
                                          "us_per_accepted_token", 2.0),
                                   False),
    "spec_agents_steps": (_scale("spec_decode/agents", dict(spec="doc"),
                                 "steps", 1.3), False),
    "quant_slot_bytes": (_scale("quant", dict(kv_quant="int8"),
                                "slot_bytes", 1.5), False),
    "quant_timing": (_scale("quant", dict(kv_quant="fp8"), "us_per_token",
                            2.0), False),
    "swap_outs_up": (_scale("swap", dict(tier="swap"), "swap_outs", 2),
                     False),
    "disagg_transfer_bytes": (_scale("disagg", dict(adoption="on"),
                                     "transfer_bytes", 1.5), False),
    # A floor counter dropped past the threshold.
    "spec_accept_rate_drop": (_scale("spec_decode/engine",
                                     dict(spec="ngram"), "accept_rate",
                                     0.5), False),
    "spec_agents_accepted_drop": (_scale("spec_decode/agents",
                                         dict(spec="doc"),
                                         "accepted_tokens", 0.5), False),
    "quant_capacity_gain_drop": (_scale("quant", dict(kv_quant="int8"),
                                        "resident_capacity_gain", 0.7),
                                 False),
    "swap_completed_drop": (_scale("swap", dict(tier="swap"), "completed",
                                   0.5), False),
    "swap_outs_down": (_scale("swap", dict(tier="swap"), "swap_outs", 0.5),
                       False),
    "disagg_adopted_drop": (_scale("disagg", dict(adoption="on"),
                                   "adopted_pages", 0.5), False),
    "floor_counter_rises": (_scale("disagg", dict(adoption="on"),
                                   "adopted_pages", 2), True),
    # Missing counters and rows.
    "missing_counter_current": (_drop("current", "rows", PAGED,
                                      "peak_pages"), False),
    "missing_counter_baseline": (_drop("baseline", "quant",
                                       dict(kv_quant="fp8"), "slot_bytes"),
                                 False),
    "missing_dense_row": (_drop_row("dense"), True),
    "missing_paged_row": (_drop_row("paged"), False),
    "missing_sweep": (lambda b, c: c.pop("disagg"), False),
    # A false acceptance flag, in each flag section.
    **{f"flag_{sec}_{name}": (_flag(sec, name), False)
       for sec, name in (
           ("admission", "chunked_stalls_below_baseline"),
           ("replication", "all_converged"),
           ("fault_tolerance", "no_lost_requests"),
           ("speculation", "streams_match"),
           ("quantization", "streams_match_int8"),
           ("memory_tiers", "swap_beats_recompute"),
           ("disaggregation", "ttft_adopt_not_worse"))},
}


@pytest.mark.parametrize("case", sorted(EDITS))
def test_verdict_and_table_match_jax(case):
    edit, want_ok = EDITS[case]
    base = _report()
    cur = copy.deepcopy(base)
    edit(base, cur)
    got = tcheck.check(copy.deepcopy(base), copy.deepcopy(cur), MAX_REG,
                       SLACK)
    want = jcheck.check(base, cur, MAX_REG, SLACK)
    assert got == want
    assert got[0] is want_ok, "\n".join(got[1])


def test_counter_tuples_match_jax():
    names = [n for n in vars(jcheck) if n.endswith("COUNTERS")]
    assert len(names) == 15
    for name in names:
        assert getattr(tcheck, name) == getattr(jcheck, name), name


def test_cli_reads_files_and_exits_on_regression(tmp_path, capsys):
    base, cur = _report(), _report()
    _row(cur, "rows", **PAGED)["read_bytes_per_step"] *= 2
    import json
    (tmp_path / "b.json").write_text(json.dumps(base))
    (tmp_path / "c.json").write_text(json.dumps(cur))
    tcheck.main(["--baseline", str(tmp_path / "b.json"),
                 "--current", str(tmp_path / "b.json")])
    assert capsys.readouterr().out.rstrip().endswith("gate passed")
    with pytest.raises(SystemExit):
        tcheck.main(["--baseline", str(tmp_path / "b.json"),
                     "--current", str(tmp_path / "c.json")])
    assert "REGRESSION" in capsys.readouterr().out


def _chip_smoke():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("section,key,name,apart", [
    ("spec_decode/engine", dict(spec="ngram"), "rollback_tokens", True),
    ("spec_decode/engine", dict(spec="doc"), "draft_tokens", True),
    ("spec_decode/agents", dict(spec="doc"), "rollback_tokens", True),
    ("spec_decode/engine", dict(spec="ngram"), "steps", False),
    ("spec_decode/engine", dict(spec="ngram"), "us_per_accepted_token",
     False),
    ("spec_decode/agents", dict(spec="doc"), "steps", False),
    ("rows", PAGED, "write_bytes_per_step", False),
])
def test_card_gate_keeps_apart_only_the_token_counts(section, key, name,
                                                     apart):
    """On the card only the speculative draft / rollback counts (and the
    int8 identity flags) may fail the gate; acceptance, steps and the
    normalized timings must pass as on the CPU."""
    base = _report()
    cur = copy.deepcopy(base)
    _row(cur, section, **key)[name] *= 2
    gate = _chip_smoke().gate_against_cpu(cur, base)
    assert not gate["ok"]
    assert (len(gate["token_dependent"]), len(gate["failed"])) == (
        (1, 0) if apart else (0, 1)), gate


def test_card_int8_ties_read_the_gaps_of_the_same_report():
    """A false int8 identity flag passes only where the report's own gaps
    are all near-ties (at most ``TIE_GAP``) and there is at least one."""
    cs = _chip_smoke()
    report = _report()
    report["quant_error"] = {"modes": {"int8": {"flip_gaps": [0.0]}}}
    for r in report["quant"]:
        r["first_diff_gaps"] = [0.015625] if r["kv_quant"] == "int8" else []
    false = list(cs.INT8_IDENTITY)
    assert cs._int8_ties(report, false) == {"teacher_forced": [0.0],
                                            "streams": [0.015625]}
    assert cs._int8_ties(report, []) == {}
    _row(report, "quant", kv_quant="int8")["first_diff_gaps"] = [0.25]
    with pytest.raises(RuntimeError, match="streams"):
        cs._int8_ties(report, false)
    report["quant_error"]["modes"]["int8"]["flip_gaps"] = []
    with pytest.raises(RuntimeError, match="teacher_forced"):
        cs._int8_ties(report, ["quantization.greedy_match_int8"])
