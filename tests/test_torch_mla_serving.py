"""The port's serving layer on the MLA model against the JAX package, on the
CPU.

Reduced ``deepseek-v2-lite-16b`` with dense FFNs (``block_pattern=
("mla",), moe=None``; 2 layers, d_model 32), float32 JAX ``lm.init``
weights carried across by ``params_from_jax``.  ``Engine.generate`` (dense
and paged latent caches) and ``ContinuousBatchingEngine.run`` (paged with
preemption by recompute, and dense) must give JAX's token streams and
``stats`` counters; over int8 latent pools the counters must be equal.
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


@pytest.fixture(scope="module")
def f32():
    cfgs = [pkg.reduced(pkg.get("deepseek-v2-lite-16b"), layers=2,
                        d_model=32, vocab=128).replace(
        block_pattern=("mla",), moe=None) for pkg in (jconfigs, tconfigs)]
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      jax.jit(jlm.init, static_argnums=1)(
                          jax.random.PRNGKey(0), cfgs[0]))
    return cfgs[0], jp, cfgs[1], convert.params_from_jax(
        jax.tree.map(np.asarray, jp), cfgs[1], device="cpu")


@pytest.mark.parametrize("paged", [False, True])
def test_mla_engine_generate_matches_jax(f32, paged):
    jcfg, jp, tcfg, tp = f32
    prompts = np.asarray([[5, 6, 7, 8, 40, 41], [9, 10, 11, 12, 3, 99]],
                         np.int32)
    want = jengine.Engine(jcfg, jp, batch=2, max_len=32, paged=paged,
                          page_size=8).generate(jnp.asarray(prompts),
                                                steps=8)
    got = tengine.Engine(tcfg, tp, batch=2, max_len=32, paged=paged,
                         page_size=8, device="cpu").generate(
        torch.from_numpy(prompts), steps=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


SCENARIOS = {
    # pool too small for both rows: growth preempts (recompute).
    "paged_preempt": (dict(batch=2, max_len=32, paged=True, page_size=8,
                           num_pages=4, chunk_size=4),
                      [(10, 12), (9, 12), (5, 4)], 3),
    "dense": (dict(batch=2, max_len=32, paged=False, chunk_size=4),
              [(5, 6), (9, 4), (3, 8)], 7),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_mla_scheduler_streams_and_counters_match_jax(f32, scenario):
    jcfg, jp, tcfg, tp = f32
    kw, spec, seed = SCENARIOS[scenario]
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


def test_mla_scheduler_int8_counters_match_jax(f32):
    jcfg, jp, tcfg, tp = f32
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(1, 128, n)]
               for n in (9, 3, 14, 6, 11)]
    kw = dict(batch=3, max_len=32, page_size=4, num_pages=18, chunk_size=4,
              kv_quant="int8")
    jeng = jsched.ContinuousBatchingEngine(jcfg, jp, **kw)
    teng = tsched.ContinuousBatchingEngine(tcfg, tp, device="cpu", **kw)
    jeng.run([jsched.Request(i, p, 6) for i, p in enumerate(prompts)])
    teng.run([tsched.Request(i, p, 6) for i, p in enumerate(prompts)])
    for name in COUNTERS:
        assert teng.stats[name] == jeng.stats[name], name
    assert teng.cache["layers"][0]["latent_pages"].dtype == torch.int8
