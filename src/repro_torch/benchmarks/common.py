"""Shared benchmark harness utilities, the port's copy of the JAX package's
``benchmarks/common.py``: the CSV row contract, the agents' sim LLM, and
the cached suite of sequential / parallel trials the paper's tables read.

The suite's cache lives under ``experiments/bench_torch/`` (never the JAX
package's ``experiments/bench/``), one file per (runs, agents, device
type), so a CPU run and a card run never read each other's trials.
"""
from __future__ import annotations

import json
import statistics
from dataclasses import asdict
from pathlib import Path

from repro_torch.agents.orchestrator import RunResult, make_sim_llm, run_task
from repro_torch.agents.tasks import TASKS

RESULTS_DIR = (Path(__file__).resolve().parents[3] / "experiments"
               / "bench_torch")

_CACHE: dict = {}


def sim_llm(device=None):
    """The agents' sim LLM (``make_sim_llm``) on ``device`` (the card
    unless ``"cpu"``), made once per process."""
    if "llm" not in _CACHE:
        _CACHE["llm"] = make_sim_llm(device=device)
    return _CACHE["llm"]


def run_suite(runs_per_mode: int = 5, n_agents: int = 4,
              tasks: list[str] | None = None, force: bool = False
              ) -> dict[str, dict[str, list[RunResult]]]:
    """Run (or load cached) sequential and parallel trials for every task.

    Results are cached to JSON so the per-table benchmarks share one suite
    (the paper's 600-trial design, scaled to the run's budget).  The
    trials run where ``sim_llm``'s parameters live (call ``sim_llm("cpu")``
    first for a CPU run).
    """
    tasks = tasks or list(TASKS)
    cfg, params = sim_llm()
    dev = params["embed"]["w"].device
    cache_f = (RESULTS_DIR
               / f"suite_r{runs_per_mode}_a{n_agents}_{dev.type}.json")
    if cache_f.exists() and not force:
        raw = json.loads(cache_f.read_text())
        return {t: {m: [RunResult(**r) for r in raw[t][m]]
                    for m in raw[t]} for t in raw if t in tasks}

    out: dict = {}
    for name in tasks:
        out[name] = {"sequential": [], "parallel": []}
        for mode in ("sequential", "parallel"):
            for run in range(runs_per_mode):
                r = run_task(cfg, params, TASKS[name], mode=mode,
                             n_agents=n_agents, seed=run, device=dev)
                out[name][mode].append(r)
    cache_f.parent.mkdir(parents=True, exist_ok=True)
    cache_f.write_text(json.dumps(
        {t: {m: [asdict(r) for r in rs] for m, rs in ms.items()}
         for t, ms in out.items()}))
    return out


def mean(xs):
    return statistics.fmean(xs) if xs else float("nan")


def stdev(xs):
    return statistics.stdev(xs) if len(xs) > 1 else 0.0


def pct_delta(seq: float, par: float) -> float:
    return 100.0 * (par - seq) / seq if seq else float("nan")


def csv_row(name: str, us_per_call: float, derived: str) -> str:
    return f"{name},{us_per_call:.1f},{derived}"
