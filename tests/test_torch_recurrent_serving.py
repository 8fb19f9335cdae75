"""The port's serving layer on the recurrent family against the JAX package,
on the CPU.

Reduced ``recurrentgemma-2b`` (rglru, rglru, local and a tail of rglru,
rglru; d_model 64, window 16) and tests/test_mixed_step.py's hybrid
``("attn", "rglru")``, float32 JAX ``lm.init`` weights carried across by
``params_from_jax``.  ``Engine.generate`` (dense and paged) and
``ContinuousBatchingEngine.run`` (paged with preemption by recompute, and
dense; contexts past the window) must give JAX's token streams and
``stats`` counters: with ``paged=True`` the recurrentgemma model pages no
layer, and the page accounting must still equal JAX's.  A row reused by a
later request starts from a fresh recurrent state.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402

COUNTERS = ("steps", "prefill_chunks", "admitted", "completed", "gen_tokens",
            "peak_pages", "grown_pages", "preemptions", "prefill_tokens",
            "decode_stall_steps")


def _f32_models(make_cfg, seed):
    cfgs = [make_cfg(pkg) for pkg in (jconfigs, tconfigs)]
    jp = jax.tree.map(lambda x: x.astype(jnp.float32), jax.jit(
        jlm.init, static_argnums=1)(jax.random.PRNGKey(seed), cfgs[0]))
    return cfgs[0], jp, cfgs[1], convert.params_from_jax(
        jax.tree.map(np.asarray, jp), cfgs[1], device="cpu")


@pytest.fixture(scope="module")
def models():
    return {
        "recurrentgemma": _f32_models(
            lambda pkg: pkg.reduced(pkg.get("recurrentgemma-2b")), 0),
        "hybrid": _f32_models(
            lambda pkg: pkg.reduced(pkg.get("olmo-1b"), d_model=32,
                                    vocab=128).replace(
                block_pattern=("attn", "rglru"), num_layers=4), 2)}


@pytest.mark.parametrize("paged", [False, True])
def test_engine_generate_matches_jax(models, paged):
    """20 steps from a 6-token prompt: every row runs past the window."""
    jcfg, jp, tcfg, tp = models["recurrentgemma"]
    prompts = np.asarray([[5, 6, 7, 8, 40, 41], [9, 10, 11, 12, 3, 99]],
                         np.int32)
    want = jengine.Engine(jcfg, jp, batch=2, max_len=32, paged=paged,
                          page_size=8).generate(jnp.asarray(prompts),
                                                steps=20)
    got = tengine.Engine(tcfg, tp, batch=2, max_len=32, paged=paged,
                         page_size=8, device="cpu").generate(
        torch.from_numpy(prompts), steps=20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


SCENARIOS = {
    # pool too small for both rows: growth preempts (recompute).
    "paged_preempt": ("recurrentgemma",
                      dict(batch=2, max_len=48, paged=True, page_size=8,
                           num_pages=5, chunk_size=4),
                      [(10, 12), (9, 12), (5, 4), (20, 6)], 3),
    "dense": ("recurrentgemma",
              dict(batch=2, max_len=48, paged=False, chunk_size=4),
              [(10, 12), (9, 12), (5, 4), (20, 6)], 3),
    "hybrid_paged": ("hybrid",
                     dict(batch=2, max_len=32, paged=True, page_size=8,
                          num_pages=4, chunk_size=4),
                     [(10, 12), (9, 12), (5, 4)], 3),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scheduler_streams_and_counters_match_jax(models, scenario):
    model, kw, spec, seed = SCENARIOS[scenario]
    jcfg, jp, tcfg, tp = models[model]
    rng = np.random.default_rng(seed)
    prompts = [[int(t) for t in rng.integers(2, 100, n)] for n, _ in spec]
    jeng = jsched.ContinuousBatchingEngine(jcfg, jp, **kw)
    want = jeng.run([jsched.Request(i, list(p), m)
                     for i, (p, (_, m)) in enumerate(zip(prompts, spec))])
    teng = tsched.ContinuousBatchingEngine(tcfg, tp, device="cpu", **kw)
    got = teng.run([tsched.Request(i, list(p), m)
                    for i, (p, (_, m)) in enumerate(zip(prompts, spec))])
    for w, g in zip(want, got):
        assert g.tokens == w.tokens, (scenario, g.rid)
    for name in COUNTERS:
        assert teng.stats[name] == jeng.stats[name], name
    if kw["paged"]:
        assert teng.stats["preemptions"] > 0
        assert teng.allocator.available == jeng.allocator.available


def test_admission_resets_a_reused_rows_state(models):
    """Back-to-back requests on one row give the tokens of fresh-engine
    solo runs (tests/test_mixed_step.py's reuse check), and JAX's."""
    jcfg, jp, tcfg, tp = models["hybrid"]
    spec = [(6, 4), (9, 5), (5, 3)]
    rng = np.random.default_rng(31)
    prompts = [[int(t) for t in rng.integers(2, 128, n)] for n, _ in spec]
    kw = dict(batch=1, max_len=32, paged=True, page_size=8, chunk_size=8)
    eng = tsched.ContinuousBatchingEngine(tcfg, tp, device="cpu", **kw)
    reqs = eng.run([tsched.Request(i, list(p), m)
                    for i, (p, (_, m)) in enumerate(zip(prompts, spec))])
    assert eng.stats["completed"] == 3
    jreqs = jsched.ContinuousBatchingEngine(jcfg, jp, **kw).run(
        [jsched.Request(i, list(p), m)
         for i, (p, (_, m)) in enumerate(zip(prompts, spec))])
    for i, (p, (_, m)) in enumerate(zip(prompts, spec)):
        solo = tsched.ContinuousBatchingEngine(tcfg, tp, device="cpu", **kw)
        want = solo.run([tsched.Request(i, list(p), m)])[0]
        assert reqs[i].tokens == want.tokens == jreqs[i].tokens, i
