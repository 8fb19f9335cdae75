"""The agent trial with speculative decoding, the port against the JAX
package on the CPU (tests/test_spec_decode.py's orchestrator cases).

``run_task`` with ``spec_decode`` ``ngram`` (sequential) and ``doc``
(parallel, 3 agents) on a task of three unconnected TODOs, paged, chunked,
int8 pools, on the bf16 sim LLM in both packages: every verify step's
inputs and all-position logits are recorded, and the runs are held by
``test_torch_agents``'s tie-aware rule (a greedy token may differ only
where JAX's top-1 / top-2 gap is at most ``TIE_GAP``; with no such flip
every result is equal, drafts and acceptance included).  The digest also
equals the port's spec-off run's, with fewer steps.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.agents import orchestrator as jorch  # noqa: E402
from repro.agents.tasks import TaskSpec as JTaskSpec  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.agents import orchestrator as torch_orch  # noqa: E402
from repro_torch.agents.tasks import TaskSpec as TTaskSpec  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from torch_agents_common import (TIE_GAP, _jax_factories,  # noqa: E402
                                 _port_factories)
from test_torch_tables import _one_thread  # noqa: E402,F401


def _verify_recorders(jlog, tlog):
    """Verify-step factories for both packages that record each step's
    inputs and all-position logits."""
    def jnote(*arrs):
        *inputs, logits = (np.asarray(a) for a in arrs)
        jlog.append(("verify", inputs, np.asarray(logits, np.float32)))

    def jverify(cfg, **_):
        def step(params, cache, tokens, start, span):
            logits, cache = jlm.mixed_step(params, cfg, tokens, cache, start,
                                           span, all_logits=True)
            jax.debug.callback(jnote, tokens, start, span, logits,
                               ordered=True)
            preds = jnp.argmax(logits, -1).astype(jnp.int32)
            return preds, jref.speculative_accept(
                preds, tokens.astype(jnp.int32),
                span.astype(jnp.int32)), cache
        return step

    def tverify(cfg, **_):
        def step(params, cache, tokens, start, span):
            logits, cache = tlm.mixed_step(params, cfg, tokens, cache, start,
                                           span, all_logits=True)
            tlog.append(("verify", [tokens.numpy().copy(),
                                    start.numpy().copy(),
                                    span.numpy().copy()],
                         logits.float().numpy()))
            preds = logits.argmax(-1).to(torch.int32)
            return preds, tref.speculative_accept(preds, tokens, span), cache
        return step

    return jverify, tverify


def _flips(jlog, tlog):
    """Walk both step records while their inputs agree; every (step, row,
    position, JAX top-2 gap) where the greedy tokens differ.  JAX's warm-up
    steps (one serve step, then all-zero-span mixed and verify steps) are
    dropped first.  With no such flip the records must be as long."""
    jlog = jlog[1:]
    while jlog and jlog[0][0] != "serve" and not jlog[0][1][2].any():
        jlog = jlog[1:]
    out = []
    for i, ((kj, ij, lj), (kt, it, lt)) in enumerate(zip(jlog, tlog)):
        assert kj == kt
        if not all(np.array_equal(a, b) for a, b in zip(ij, it)):
            break
        if kj != "verify":
            lj, lt = lj[:, None], lt[:, None]
            span = np.ones(len(lj), np.int64) if kj == "serve" else \
                np.minimum(ij[2], 1)
        else:
            span = ij[2]
        top2 = np.sort(lj, axis=-1)[..., -2:]
        for r in range(lj.shape[0]):
            for j in range(int(span[r])):
                if lj[r, j].argmax() != lt[r, j].argmax():
                    out.append((i, r, j, float(top2[r, j, 1]
                                               - top2[r, j, 0])))
    if not out:
        assert len(jlog) == len(tlog)
    return out


@pytest.fixture(scope="module")
def sim():
    jcfg, jp = jorch.make_sim_llm(0)
    tcfg = tconfigs.reduced(tconfigs.get("olmo-1b"), d_model=64,
                            vocab=512).replace(num_layers=2)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    return jcfg, jp, tcfg, tp


SMALL = dict(name="small", coupling="low", n_todos=3, deps={}, reads={},
             base_tokens=16, par_inflation=1.0, prompt_tokens=12,
             read_prompt_tokens=4)
TRIAL_CASES = {"seq-ngram": dict(mode="sequential", spec_decode="ngram"),
               "par-doc": dict(mode="parallel", n_agents=3,
                               spec_decode="doc")}


@pytest.mark.parametrize("case", sorted(TRIAL_CASES))
def test_trial_spec_matches_jax(sim, case, monkeypatch):
    jcfg, jp, tcfg, tp = sim
    kw = dict(seed=0, max_len=128, kv="paged", prefill="chunked",
              page_size=16, chunk_size=16, kv_quant="int8")
    kw.update(TRIAL_CASES[case])
    jlog, tlog = [], []
    serve, mixed = _jax_factories(jlog)
    monkeypatch.setattr(jengine, "make_serve_step", serve)
    monkeypatch.setattr(jengine, "make_mixed_step_fn", mixed)
    serve, mixed = _port_factories(tlog)
    monkeypatch.setattr(tengine, "make_serve_step", serve)
    monkeypatch.setattr(tengine, "make_mixed_step_fn", mixed)
    jverify, tverify = _verify_recorders(jlog, tlog)
    monkeypatch.setattr(jengine, "make_verify_step_fn", jverify)
    monkeypatch.setattr(tengine, "make_verify_step_fn", tverify)
    rj = jorch.run_task(jcfg, jp, JTaskSpec(**SMALL), **kw)
    rt = torch_orch.run_task(tcfg, tp, TTaskSpec(**SMALL), device="cpu",
                             **kw)
    assert rj.converged and rt.converged
    assert rt.spec_decode == kw["spec_decode"] and rt.draft_tokens > 0
    flips = _flips(jlog, tlog)
    for step, row, pos, gap in flips:
        assert gap <= TIE_GAP, (
            f"greedy token differs at step {step} row {row} position "
            f"{pos} with JAX top-2 gap {gap}: not a near-tie")
    if not flips:
        # No greedy token differed: every step and result follows, drafts
        # and acceptance included.  (A flip parts the runs, and the step
        # count follows the tokens under speculation.)
        dj, dt = vars(rj), vars(rt)
        for k in dj:
            if k != "wall_s":
                assert dj[k] == dt[k], (k, dj[k], dt[k])
    off = torch_orch.run_task(tcfg, tp, TTaskSpec(**SMALL), device="cpu",
                              **{**kw, "spec_decode": "off"})
    assert rt.digest == off.digest
    assert rt.gen_tokens == off.gen_tokens
    assert rt.steps <= off.steps
    if kw["mode"] == "sequential":
        assert rt.steps < off.steps
