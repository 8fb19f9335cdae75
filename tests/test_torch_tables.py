"""The paper's tables in the port against the JAX package, on the CPU.

* One suite of seeded ``RunResult``s: the port's ``table3``, ``table4``,
  ``table5``, ``table7`` and ``rq3_consistency`` print the same rows as
  JAX's ``benchmarks/tables.py``.
* A tiny ``run_suite`` (one run a mode, two tasks, two agents) in both
  packages with JAX's sim-LLM weights in the port's ``_CACHE``: trial by
  trial held by ``test_torch_agents``'s tie-aware rule (every model step's
  inputs and logits recorded); without a near-tie flip the table rows are
  equal but for the wall times.  The port's cache file lands under its own
  results directory with the device type in its name, never under JAX's,
  and reads back as the same results.

The tiny ``table6`` sweep is in test_torch_table6.py (one file a worker).
"""
from __future__ import annotations

import re
from dataclasses import asdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from benchmarks import common as jcommon  # noqa: E402
from benchmarks import tables as jtables  # noqa: E402
from repro.agents import orchestrator as jorch  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.agents import orchestrator as torch_orch  # noqa: E402
from repro_torch.agents.tasks import TASKS  # noqa: E402
from repro_torch.benchmarks import common as tcommon  # noqa: E402
from repro_torch.benchmarks import tables as ttables  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from torch_agents_common import (TIE_GAP, TOKEN_DEPENDENT,  # noqa: E402
                                 _first_flips, _jax_factories,
                                 _port_factories)

SUITE_TABLES = ("table3", "table4", "table5", "table7", "rq3_consistency")


def _fields(rng, task, mode):
    steps = int(rng.integers(200, 3000))
    return dict(task=task, mode=mode, n_agents=1 if mode == "sequential"
                else 4, wall_s=float(rng.uniform(0.5, 20.0)),
                gen_tokens=int(rng.integers(100, 2000)),
                replay_tokens=int(rng.integers(0, 500)), steps=steps,
                invalidations=int(rng.integers(0, 20)),
                claim_collisions=int(rng.integers(0, 30)),
                observation_events=int(rng.integers(0, 900)),
                semantic_conflicts=int(rng.integers(0, 40)),
                declared_symbols=int(rng.integers(0, 200)),
                converged=bool(rng.random() < 0.9),
                digest=int(rng.integers(0, 2**31)))


def test_suite_tables_print_jax_rows():
    rng = np.random.default_rng(0)
    raw = {t: {m: [_fields(rng, t, m) for _ in range(3)]
               for m in ("sequential", "parallel")} for t in TASKS}
    jsuite = {t: {m: [jorch.RunResult(**f) for f in fs]
                  for m, fs in ms.items()} for t, ms in raw.items()}
    tsuite = {t: {m: [torch_orch.RunResult(**f) for f in fs]
                  for m, fs in ms.items()} for t, ms in raw.items()}
    for name in SUITE_TABLES:
        want = getattr(jtables, name)(jsuite)
        assert want and getattr(ttables, name)(tsuite) == want, name


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The sim LLM is 64 wide: one intra-op thread runs its trials as fast,
    and leaves the cores to the test run's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sim():
    jcfg, jp = jorch.make_sim_llm(0)
    tcfg = tconfigs.reduced(tconfigs.get("olmo-1b"), d_model=64,
                            vocab=512).replace(num_layers=2)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture
def both(sim, tmp_path, monkeypatch):
    """Both packages' sim LLM caches on the same weights and their results
    directories under ``tmp_path``."""
    jcfg, jp, tcfg, tp = sim
    monkeypatch.setitem(jcommon._CACHE, "llm", (jcfg, jp))
    monkeypatch.setitem(tcommon._CACHE, "llm", (tcfg, tp))
    monkeypatch.setattr(jcommon, "RESULTS_DIR", tmp_path / "bench")
    monkeypatch.setattr(tcommon, "RESULTS_DIR", tmp_path / "bench_torch")
    (tmp_path / "bench").mkdir()
    return tmp_path


def _recording(module, engine, factories, trials, monkeypatch):
    """Wrap ``module.run_task`` so each trial records its model steps
    (inputs and logits) in a log of its own, appended to ``trials``."""
    inner = module.run_task

    def run_task(*a, **kw):
        log = []
        serve, mixed = factories(log)
        with monkeypatch.context() as m:
            m.setattr(engine, "make_serve_step", serve)
            m.setattr(engine, "make_mixed_step_fn", mixed)
            r = inner(*a, **kw)
        trials.append((r, log))
        return r
    monkeypatch.setattr(module, "run_task", run_task)


def _strip_wall(row: str) -> str:
    return re.sub(r"wall_(seq|par)=[0-9.]+s", "wall", row)


def test_tiny_suite_matches_jax_trial_by_trial(both, monkeypatch):
    jtrials, ttrials = [], []
    _recording(jcommon, jengine, _jax_factories, jtrials, monkeypatch)
    _recording(tcommon, tengine, _port_factories, ttrials, monkeypatch)
    kw = dict(runs_per_mode=1, n_agents=2,
              tasks=["tic_tac_toe", "registration"], force=True)
    jsuite = jcommon.run_suite(**kw)
    tsuite = tcommon.run_suite(**kw)
    assert len(jtrials) == len(ttrials) == 4
    flipped = False
    for (rj, jlog), (rt, tlog) in zip(jtrials, ttrials):
        assert rj.converged and rt.converged
        dj, dt = vars(rj), vars(rt)
        for k in dj:
            if k not in TOKEN_DEPENDENT:
                assert dj[k] == dt[k], (rj.task, rj.mode, k)
        flips = _first_flips(jlog, tlog)
        if any(dj[k] != dt[k] for k in TOKEN_DEPENDENT - {"wall_s"}):
            assert flips, "results differ but no greedy token differed"
        for step, row, gap, diff in flips:
            assert gap <= TIE_GAP, (rj.task, rj.mode, step, row, gap, diff)
        flipped |= bool(flips)
    if not flipped:
        for name in SUITE_TABLES:
            want = [_strip_wall(r) for r in getattr(jtables, name)(jsuite)]
            got = [_strip_wall(r) for r in getattr(ttables, name)(tsuite)]
            assert got == want, name

    # The cache: the port's own file, the device type in its name; JAX's
    # directory holds JAX's file only.
    assert sorted(p.name for p in (both / "bench_torch").iterdir()) == [
        "suite_r1_a2_cpu.json"]
    assert sorted(p.name for p in (both / "bench").iterdir()) == [
        "suite_r1_a2.json"]
    back = tcommon.run_suite(runs_per_mode=1, n_agents=2,
                             tasks=["tic_tac_toe", "registration"])
    assert len(ttrials) == 4                  # read back, nothing ran
    for t in tsuite:
        for m in tsuite[t]:
            assert [asdict(r) for r in back[t][m]] == \
                [asdict(r) for r in tsuite[t][m]]
            for r in back[t][m]:
                assert all(type(v) in (int, float, str, bool)
                           for v in asdict(r).values())


def test_results_dir_is_the_ports_own():
    assert tcommon.RESULTS_DIR.parts[-2:] == ("experiments", "bench_torch")
    assert tcommon.RESULTS_DIR.parent == jcommon.RESULTS_DIR.parent
    assert tcommon.RESULTS_DIR != jcommon.RESULTS_DIR
