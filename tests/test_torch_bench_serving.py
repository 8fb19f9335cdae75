"""The port's serving benchmark against the JAX package's, sweep by sweep,
on the CPU.

Every sweep of ``repro_torch.benchmarks.bench_serving`` runs against JAX's
``benchmarks.bench_serving`` function with the same arguments, at the
smallest sizes that still exercise it, on the agents' sim LLM (reduced
OLMo-1B) with JAX's weights in float32 (``convert.params_from_jax``):
every field of every row but the timings must be equal — each counter
``check_regression`` gates, the analytic bytes, and every flag (stream
identity, digest match, convergence, the chaos invariants) — and the
timing fields must be present and positive.  The quant-error report's
flags are equal and its logit errors agree within a fiftieth of the int8
budget.  Last, the
port's whole ``run_bench --quick`` on the CPU passes the port's gate
against itself with every acceptance flag true.

JAX's ``ReplicatedPageStore`` state is built from host copies
(``test_torch_jax_state._jax_state_from_copies``), and JAX's step
factories (``engine.make_mixed_step_fn`` and its kin) return one function
per (config, options) for the module: every engine a sweep builds jits
that same function, so JAX compiles a step shape once, not once an
engine (the factories are pure: the steps are the same either way).
"""
from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import bench_serving as jbench  # noqa: E402
from repro.agents import orchestrator as jorch  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.benchmarks import bench_serving as tbench  # noqa: E402
from repro_torch.benchmarks import check_regression as tcheck  # noqa: E402
from test_torch_jax_state import _jax_state_from_copies  # noqa: E402,F401

TIMING = ("us_per_token", "us_per_step", "ttft_ms_mean", "itl_p50_us",
          "itl_p99_us", "admission_us", "us_per_accepted_token", "wall_s")
SMALL = dict(max_len=32, page_size=8)
# The port's own report fields (not in JAX's): the bf16 top-2 gaps where
# a quantized run parts from the bf16 pool's (``_gaps_follow_flags``).
PORT_ONLY = ("first_diff_gaps",)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """A 64-wide model: one intra-op thread runs it as fast, and leaves
    the cores to the test run's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _jax_steps_once():
    made = {}

    def once(name, factory):
        def make(cfg, **kw):
            key = (name, cfg, tuple(sorted(kw.items())))
            if key not in made:
                made[key] = factory(cfg, **kw)
            return made[key]
        return make

    with pytest.MonkeyPatch.context() as mp:
        for name in ("make_serve_step", "make_prefill_fn",
                     "make_ragged_prefill_fn", "make_mixed_step_fn",
                     "make_verify_step_fn"):
            mp.setattr(jengine, name, once(name, getattr(jengine, name)))
        yield


def _f32(jp):
    return jax.tree.map(lambda x: x.astype(jnp.float32), jp)


def _port(jp, tcfg):
    return convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                   device="cpu")


@pytest.fixture(scope="module")
def sim():
    jcfg, jp = jorch.make_sim_llm(0)
    jp = _f32(jp)
    tcfg = tconfigs.reduced(tconfigs.get("olmo-1b"), d_model=64,
                            vocab=512).replace(num_layers=2)
    return jcfg, jp, tcfg, _port(jp, tcfg)


@pytest.fixture(scope="module")
def qsim(sim):
    """The quant sweep's model: one 64-wide head (as ``run_bench``)."""
    jcfg, _, tcfg, _ = sim
    jq = jcfg.replace(num_heads=1, num_kv_heads=1, head_dim=64)
    tq = tcfg.replace(num_heads=1, num_kv_heads=1, head_dim=64)
    from repro.models import lm as jlm
    jp = _f32(jax.jit(jlm.init, static_argnums=1)(jax.random.PRNGKey(0), jq))
    return jq, jp, tq, _port(jp, tq)


def _hold(got, want):
    """Rows (a dict, or lists / tuples of them) equal but for timings,
    which must be present and positive in both."""
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _hold(g, w)
        return
    assert set(got) - set(PORT_ONLY) == set(want)
    for k, w in want.items():
        if k in TIMING:
            assert got[k] > 0 and w > 0, k
        else:
            assert got[k] == w, (k, got[k], w)


def _both(fn_name, sim, **kw):
    jcfg, jp, tcfg, tp = sim
    return (getattr(tbench, fn_name)(tcfg, tp, **kw),
            getattr(jbench, fn_name)(jcfg, jp, **kw))


@pytest.mark.parametrize("paged", [False, True])
def test_run_config_matches_jax(sim, paged):
    got, want = _both("run_config", sim, batch=2, skew="ragged",
                      paged=paged, n_requests=3, prompt_hi=20, max_new=2,
                      **SMALL)
    _hold(got, want)
    assert got["admitted_mid_flight"] > 0 and got["completed"] == 3


def test_chunked_admission_matches_jax(sim):
    got, want = _both("run_chunked_admission", sim, batch=2, n_requests=6,
                      prompt_hi=20, max_new=4, chunks=(8,), **SMALL)
    _hold(got, want)
    assert [r["admission"] for r in got] == ["stalled", "chunked"]
    assert got[1]["decode_stall_steps"] < got[0]["decode_stall_steps"]


def test_prefix_share_matches_jax(sim):
    got, want = _both("run_prefix_share", sim, fanout=2, prompt_len=13,
                      max_new=2, share=True, **SMALL)
    _hold(got, want)
    assert got["shared_pages"] > 0 and got["cow_copies"] > 0


def test_replicated_matches_jax(sim):
    got, want = _both("run_replicated", sim, replicas=2, batch=2,
                      prompt_len=13, max_new=2, **SMALL)
    _hold(got, want)
    assert got["converged"] and got["cross_replica_hits"] > 0


def test_disagg_matches_jax(sim):
    (grow, gstreams), (wrow, wstreams) = _both(
        "run_disagg", sim, replicas=2, batch=2, prompt_len=13, max_new=4,
        adopt=True, **SMALL)
    _hold(grow, wrow)
    assert gstreams == wstreams
    assert grow["adopted_pages"] > 0 and grow["converged"]


def test_fault_sweep_matches_jax(sim):
    got, want = _both("run_fault_sweep", sim, schedules=("lossy",),
                      crash_ats=(4,))
    _hold(got, want)
    assert all(r["ok"] for r in got) and got[1]["recovered"] > 0


def test_spec_decode_matches_jax(sim):
    got, want = _both("run_spec_decode", sim, batch=2, n_requests=2,
                      prompt_hi=20, max_new=8, spec_k=4, chunk_size=8,
                      **SMALL)
    _hold(got, want)
    assert all(r["streams_match"] for r in got)
    assert all(r["accept_rate"] > 0 for r in got if r["spec"] != "off")


def test_spec_agents_match_jax(sim, monkeypatch):
    """On ``tic_tac_toe`` cut to 3 TODOs of 24 tokens in both packages
    (the sweep runs that task; the whole one takes JAX ~25 s)."""
    import dataclasses

    from repro.agents import tasks as jtasks
    from repro_torch.agents import tasks as ttasks
    for mod in (jtasks, ttasks):
        task = mod.TASKS["tic_tac_toe"]
        monkeypatch.setitem(mod.TASKS, "tic_tac_toe", dataclasses.replace(
            task, n_todos=3, base_tokens=24,
            reads={k: tuple(j for j in v if j < 3)
                   for k, v in task.reads.items() if k < 3}))
    got, want = _both("run_spec_agents", sim, spec_k=4, max_len=256,
                      page_size=16, chunk_size=16)
    _hold(got, want)
    assert all(r["digest_match"] for r in got)
    assert got[1]["steps"] < got[0]["steps"] and got[1]["accepted_tokens"]


def test_quant_sweep_matches_jax(qsim):
    got, want = _both("run_quant_sweep", qsim, batch=2, n_requests=3,
                      prompt_hi=12, max_new=2, chunk_size=8, **SMALL)
    _hold(got, want)
    assert [r["kv_quant"] for r in got] == ["off", "int8", "fp8"]
    assert all(r["resident_capacity_gain"] >= 1.8 for r in got[1:])
    for r in got:
        _gaps_follow_flags(r["first_diff_gaps"], r["streams_match"])


def _gaps_follow_flags(gaps, identical):
    """A gap list is empty exactly where the run matched the bf16 pool's,
    and holds top-2 gaps (>= 0) otherwise."""
    assert isinstance(gaps, list)
    assert (not gaps) == identical, (gaps, identical)
    assert all(g >= 0 for g in gaps)


def test_quant_error_report_matches_jax(qsim):
    got, want = _both("quant_error_report", qsim, max_len=32, page_size=8,
                      prompt_len=6, decode_steps=1)
    assert set(got) == set(want)
    for k in ("batch", "prompt_len", "decode_steps", "page_size",
              "greedy_match_int8", "all_within_tol"):
        assert got[k] == want[k], k
    assert set(got["modes"]) == set(want["modes"]) == {"int8", "fp8"}
    for mode, w in want["modes"].items():
        g = got["modes"][mode]
        for k in ("greedy_match", "tolerance", "within_tol"):
            assert g[k] == w[k], (mode, k)
        _gaps_follow_flags(g["flip_gaps"], g["greedy_match"])
        # The frameworks' K/V differ in their last float32 bits, which can
        # move a row's scale and a code one quantum: the errors agree to a
        # fiftieth of the int8 budget (0.25), not to float32 noise.
        np.testing.assert_allclose(g["logit_max_abs"], w["logit_max_abs"],
                                   atol=5e-3)
        np.testing.assert_allclose(g["logit_mse"], w["logit_mse"],
                                   rtol=0.1)


def test_swap_sweep_matches_jax(sim):
    got, want = _both("run_swap_sweep", sim)
    _hold(got, want)
    assert got[1]["steps"] < got[0]["steps"] and got[1]["swap_outs"] > 0


def test_run_bench_quick_passes_its_own_gate(tmp_path):
    """The whole quick bench on the CPU: its report, its quant-error file
    and CSV rows, every acceptance flag true, and the gate passes a report
    against itself."""
    rows = []
    report = tbench.run_bench(quick=True, out=tmp_path / "b.json",
                              emit_csv=rows.append, device="cpu")
    assert json.loads((tmp_path / "b.json").read_text()) == json.loads(
        json.dumps(report))
    assert (json.loads((tmp_path / tbench.QUANT_OUT).read_text())
            == json.loads(json.dumps(report["quant_error"])))
    assert rows and all(r.startswith("serving/") and r.count(",") == 2
                        for r in rows)
    for section in ("fault_tolerance", "replication", "disaggregation",
                    "quantization", "memory_tiers", "speculation"):
        assert all(report[section].values()), (section, report[section])
    assert report["admission"]["all_completed"]
    assert report["admission"]["chunked_stalls_below_baseline"]
    ok, lines = tcheck.check(report, report, 0.15, 0.50)
    assert ok, "\n".join(lines)


def test_first_diff_gaps_are_the_reference_models_top2_gaps(sim):
    """Where a stream parts from the reference's, the gap the quant sweep
    reports is the top-2 gap of the reference model's logits at the
    first differing token: JAX's forward over the same prefix gives it."""
    from repro.models import lm as jlm
    jcfg, jp, tcfg, tp = sim
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(2, 512, n)] for n in (5, 7)]
    ref = {0: [11, 12, 13], 1: [21, 22, 23]}
    got = {0: [11, 12, 13], 1: [21, 99, 23]}
    gaps = tbench._first_diff_gaps(tcfg, tp, prompts, ref, got)
    logits, _ = jlm.forward(jp, jcfg, jnp.asarray([prompts[1] + [21]]))
    top2 = np.sort(np.asarray(logits[0, -1], np.float64))[-2:]
    assert len(gaps) == 1
    np.testing.assert_allclose(gaps[0], top2[1] - top2[0], atol=1e-4)
