"""The port's serving layer against the JAX package, on the CPU.

``Engine.generate`` (dense and paged caches) and
``ContinuousBatchingEngine.run`` (mid-flight admission, preemption by
recompute, a token budget, the stalled-admission baseline, dense mode) run
with the same weights in both packages.  With float32 weights the token
streams and the ``stats`` counters must be equal.  With bf16 weights the
engine streams must be equal up to the first step where JAX's top-1/top-2
logit gap is below 0.2 (twice the bf16 logit tolerance of
tests/test_torch_model.py): there the two frameworks' roundings may pick
either token.
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

TIE_GAP = 0.2
COUNTERS = ("steps", "prefill_chunks", "admitted", "completed", "gen_tokens",
            "peak_pages", "grown_pages", "preemptions", "prefill_tokens",
            "decode_stall_steps")


def _models(dtype):
    jcfg = jconfigs.reduced(jconfigs.get("olmo-1b"), d_model=32, vocab=128)
    tcfg = tconfigs.reduced(tconfigs.get("olmo-1b"), d_model=32, vocab=128)
    jp = jax.tree.map(lambda x: x.astype(dtype),
                      jlm.init(jax.random.PRNGKey(0), jcfg))
    return jcfg, jp, tcfg, convert.params_from_jax(
        jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@pytest.fixture(scope="module")
def f32():
    return _models(jnp.float32)


@pytest.fixture(scope="module")
def bf16():
    return _models(jnp.bfloat16)


PROMPTS = np.asarray([[5, 6, 7, 8, 40, 41], [9, 10, 11, 12, 3, 99]],
                     np.int32)


@pytest.mark.parametrize("paged", [False, True])
def test_engine_generate_matches_jax(f32, paged):
    jcfg, jp, tcfg, tp = f32
    want = jengine.Engine(jcfg, jp, batch=2, max_len=32, paged=paged,
                          page_size=8).generate(jnp.asarray(PROMPTS),
                                                steps=10)
    got = tengine.Engine(tcfg, tp, batch=2, max_len=32, paged=paged,
                         page_size=8, device="cpu").generate(
        torch.from_numpy(PROMPTS), steps=10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_gaps(jcfg, jp, prompts, stream, paged):
    """JAX's top-1/top-2 logit gap at every step of ``stream`` (teacher
    forced), on the cache layout the engine used."""
    b, t = prompts.shape
    cache = jengine.Engine(jcfg, jp, batch=b, max_len=32, paged=paged,
                           page_size=8).cache
    logits, cache = jlm.prefill(jp, jcfg, jnp.asarray(prompts), cache)
    gaps = []
    for i in range(stream.shape[1]):
        top2 = np.sort(np.asarray(logits, np.float32), -1)[:, -2:]
        gaps.append(top2[:, 1] - top2[:, 0])
        logits, cache = jlm.decode_step(
            jp, jcfg, jnp.asarray(stream[:, i]), cache,
            jnp.full((b,), t + i, jnp.int32))
    return np.stack(gaps, 1)


@pytest.mark.parametrize("paged", [False, True])
def test_engine_generate_bf16_matches_jax_up_to_ties(bf16, paged):
    jcfg, jp, tcfg, tp = bf16
    want = np.asarray(jengine.Engine(jcfg, jp, batch=2, max_len=32,
                                     paged=paged, page_size=8).generate(
        jnp.asarray(PROMPTS), steps=10))
    got = tengine.Engine(tcfg, tp, batch=2, max_len=32, paged=paged,
                         page_size=8, device="cpu").generate(
        torch.from_numpy(PROMPTS), steps=10).numpy()
    gaps = _jax_gaps(jcfg, jp, PROMPTS, want, paged)
    for row in range(want.shape[0]):
        diff = np.nonzero(got[row] != want[row])[0]
        if diff.size:
            assert gaps[row, diff[0]] < TIE_GAP, (row, diff[0],
                                                   gaps[row, diff[0]])


SCENARIOS = {
    # tests/test_paged_serving.py:216 — a late request reuses the pages of
    # a finished one while the long row keeps decoding.
    "mid_flight": (dict(batch=2, max_len=32, paged=True, page_size=8,
                        num_pages=6), [(6, 12), (4, 2), (5, 3)], 9),
    # pool too small for both rows: growth preempts (recompute).
    "preempt": (dict(batch=2, max_len=32, paged=True, page_size=8,
                     num_pages=4, chunk_size=4), [(10, 12), (9, 12)], 3),
    "token_budget": (dict(batch=3, max_len=32, paged=True, page_size=8,
                          chunk_size=4, token_budget=6),
                     [(9, 4), (5, 6), (3, 8), (7, 5), (4, 3)], 7),
    "stalled_admission": (dict(batch=2, max_len=32, paged=True, page_size=8,
                               prefill_interleave=False),
                          [(5, 6), (9, 4), (3, 8)], 7),
    "dense": (dict(batch=2, max_len=32, paged=False, chunk_size=4),
              [(5, 6), (9, 4), (3, 8), (7, 5)], 7),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scheduler_streams_and_counters_match_jax(f32, scenario):
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
        assert (g.admitted_step, g.first_token_step, g.finished_step) == (
            w.admitted_step, w.first_token_step, w.finished_step)
    for name in COUNTERS:
        assert teng.stats[name] == jeng.stats[name], name
    if scenario == "preempt":
        assert teng.stats["preemptions"] > 0
    if kw["paged"]:
        assert teng.allocator.available == jeng.allocator.available


# Options of JAX's scheduler: the first, fifth, sixth and seventh are
# ported (queue 1 items 7 and 12) and construct; the others still raise,
# naming their ROADMAP.md item.
PORTED_OPTIONS = ("prefix_sharing", "max_queue", "journal", "role")


@pytest.mark.parametrize("option", [
    dict(prefix_sharing=True), dict(spec_decode="ngram"),
    dict(spec_decode="doc"), dict(swap_tier_pages=4), dict(max_queue=2),
    dict(journal=print), dict(role="prefill")])
def test_scheduler_options_not_ported_name_their_roadmap_item(f32, option):
    _, _, tcfg, tp = f32
    (name, value), = option.items()
    if name in PORTED_OPTIONS:
        eng = tsched.ContinuousBatchingEngine(tcfg, tp, batch=1, max_len=16,
                                              page_size=8, device="cpu",
                                              **option)
        held = {"journal": eng._journal}.get(name, getattr(eng, name, None))
        assert held == value
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tsched.ContinuousBatchingEngine(tcfg, tp, batch=1, max_len=16,
                                        page_size=8, device="cpu", **option)


def test_prefix_sharing_cow_matches_jax(f32):
    """COW prefix sharing (tests/test_paged_serving.py's fan-out): clones of
    one prompt admitted together and later share its pages; the first
    divergent write into a shared boundary page copies it.  Streams,
    lifecycle steps and every counter (shared pages, COW copies, growth)
    equal JAX's, and clones decode the same stream."""
    jcfg, jp, tcfg, tp = f32
    rng = np.random.default_rng(5)
    base = [int(t) for t in rng.integers(2, 100, 13)]
    other = [int(t) for t in rng.integers(2, 100, 9)]
    spec = [(base, 5), (base, 5), (other, 4), (base, 6), (base[:8], 3)]
    kw = dict(batch=3, max_len=32, paged=True, page_size=4, chunk_size=4,
              prefix_sharing=True)
    jeng = jsched.ContinuousBatchingEngine(jcfg, jp, **kw)
    teng = tsched.ContinuousBatchingEngine(tcfg, tp, device="cpu", **kw)
    want = jeng.run([jsched.Request(i, list(p), m)
                     for i, (p, m) in enumerate(spec)])
    got = teng.run([tsched.Request(i, list(p), m)
                    for i, (p, m) in enumerate(spec)])
    for w, g in zip(want, got):
        assert g.tokens == w.tokens, g.rid
        assert (g.admitted_step, g.first_token_step, g.finished_step) == (
            w.admitted_step, w.first_token_step, w.finished_step)
    for name, v in teng.stats.items():
        if name != "admit_s":
            assert v == jeng.stats[name], name
    assert teng.stats["shared_pages"] > 0 and teng.stats["cow_copies"] > 0
    assert got[0].tokens == got[1].tokens[:5]
    assert teng.allocator.available == jeng.allocator.available \
        == teng.allocator.num_pages


def test_scheduler_helpers_match_jax():
    for n in (1, 3, 8, 9, 33, 64):
        assert tengine.width_bucket(n, 32) == jengine.width_bucket(n, 32)
    for c in (1, 5, 16, 64):
        assert (tengine.mixed_width_buckets(c)
                == jengine.mixed_width_buckets(c))
    for rid, attempt in [(0, 1), (3, 2), (17, 5)]:
        assert (tengine.backoff_steps(rid, attempt)
                == jengine.backoff_steps(rid, attempt))
    for n in (1, 8, 9, 100, 1024):
        assert tengine.bucket_len(n) == jengine.bucket_len(n)
    alloc_t, alloc_j = tsched.PageAllocator(5), jsched.PageAllocator(5)
    assert alloc_t.alloc(3) == alloc_j.alloc(3)
    assert alloc_t.alloc(0) == [] and alloc_t.alloc(3) is None


def test_sample_token_at_temperature_uses_the_generator():
    logits = torch.randn(4, 50, generator=torch.Generator().manual_seed(0))
    draws = [tengine.sample_token(logits, torch.Generator().manual_seed(7),
                                  temperature=0.8) for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    assert torch.equal(tengine.sample_token(logits, None),
                       logits.argmax(-1).to(torch.int32))
    with pytest.raises(ValueError, match="Generator"):
        tengine.sample_token(logits, None, temperature=1.0)
