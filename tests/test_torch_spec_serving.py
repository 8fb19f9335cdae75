"""Speculative decoding in the port's scheduler against the JAX package,
on the CPU (the scheduler cases of tests/test_spec_decode.py that have a
port counterpart).

``ContinuousBatchingEngine`` with ``ngram``, ``doc`` and an adversarial
drafter, dense mode and chunks 2 / 4 / 16, and copy-on-write prefix pages,
in both packages with the same float32 weights: streams and the five spec
counters equal JAX's, and the streams equal the port's own
non-speculative greedy streams, with no page leaked; the guards raise as
JAX's.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch.serving import draft as tdraft  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402
from test_torch_spec_decode import PS, V, _models  # noqa: E402
from test_torch_tables import _one_thread  # noqa: E402,F401

SPEC_STATS = ("draft_tokens", "accepted_tokens", "rollback_tokens",
              "spec_steps", "spec_rollbacks")


class _BadDrafter:
    """Adversarial: always proposes the same (almost surely wrong) run."""

    name = "bad"

    def __init__(self, tok=127):
        self.tok = tok

    def propose(self, ctx, k):
        return [self.tok] * k


def _spec_prompts(n=5):
    pat = np.random.RandomState(0).randint(0, V, size=6).tolist()
    return [(pat * 4)[:12 + i] for i in range(n)]


def _run(pkg, cfg, params, prompts, spec, drafter=None, max_new=8, **kw):
    eng_kw = dict(batch=3, max_len=64, page_size=PS, chunk_size=8)
    eng_kw.update(kw)
    extra = {"device": "cpu"} if pkg is tsched else {}
    eng = pkg.ContinuousBatchingEngine(cfg, params, spec_decode=spec,
                                       spec_k=4, drafter=drafter,
                                       **eng_kw, **extra)
    reqs = eng.run([pkg.Request(rid=i, prompt=list(p),
                                max_new_tokens=max_new)
                    for i, p in enumerate(prompts)])
    return eng, [r.tokens for r in reqs]


def _hold_scheduler(kind, spec, drafter=None, prompts=None, max_new=8,
                    **kw):
    """The JAX and port engines with ``spec`` (the same drafter object
    type in each), and the port's spec-off run: streams and spec counters
    equal JAX's, streams equal the greedy ones, no page leaked."""
    jcfg, jp, tcfg, tp = _models(kind)
    prompts = prompts or _spec_prompts()
    mk = drafter or (lambda: None)
    jeng, jgot = _run(jsched, jcfg, jp, prompts, spec, mk(), max_new, **kw)
    teng, tgot = _run(tsched, tcfg, tp, prompts, spec, mk(), max_new, **kw)
    teng0, base = _run(tsched, tcfg, tp, prompts, "off", None, max_new, **kw)
    assert tgot == jgot
    assert tgot == base
    for name in SPEC_STATS + ("steps", "gen_tokens", "completed"):
        assert teng.stats[name] == jeng.stats[name], name
    if teng.paged:
        assert teng.allocator.available == teng.allocator.num_pages
    return teng, teng0


@pytest.mark.parametrize("kind", ["mha", "mla", "hybrid"])
def test_scheduler_ngram_matches_jax_and_greedy(kind):
    eng, eng0 = _hold_scheduler(kind, "ngram")
    assert eng.stats["draft_tokens"] > 0
    assert eng.stats["accepted_tokens"] > 0
    # Fewer steps where acceptance shortens the longest request (the MLA
    # model's accepted drafts fall on rows that do not end the run).
    assert eng.stats["steps"] <= eng0.stats["steps"]
    if kind != "mla":
        assert eng.stats["steps"] < eng0.stats["steps"]


def test_scheduler_doc_drafter_matches_jax():
    """A doc drafter seeded with the converged streams accepts nearly
    everything, in both packages alike."""
    _, _, tcfg, tp = _models("mha")
    prompts = _spec_prompts()
    _, base = _run(tsched, tcfg, tp, prompts, "off")
    docs = [list(p) + list(t) for p, t in zip(prompts, base)]

    def doc():
        d = tdraft.DocDrafter()
        d.set_docs(docs)
        return d
    eng, _ = _hold_scheduler("mha", "doc", drafter=doc)
    assert eng.spec_accept_rate > 0.5


def test_scheduler_adversarial_drafter_matches_jax():
    eng, _ = _hold_scheduler("mha", "ngram", drafter=_BadDrafter)
    assert eng.stats["rollback_tokens"] > 0
    assert eng.stats["accepted_tokens"] == 0


@pytest.mark.parametrize("chunk", [2, 4, 16])
def test_scheduler_spec_across_chunk_sizes_matches_jax(chunk):
    _hold_scheduler("mha", "ngram", chunk_size=chunk)


def test_scheduler_spec_dense_mode_matches_jax():
    eng, _ = _hold_scheduler("mha", "ngram", paged=False)
    assert eng.stats["accepted_tokens"] > 0


def test_scheduler_cow_prefix_shared_rollback_no_double_free():
    prompt = np.random.RandomState(1).randint(0, V, size=17).tolist()
    eng, _ = _hold_scheduler("mha", "ngram",
                             drafter=lambda: _BadDrafter(126),
                             prompts=[prompt] * 6, batch=4,
                             prefix_sharing=True)
    assert eng.stats["rollback_tokens"] > 0
    assert eng.stats["shared_pages"] > 0


def test_scheduler_spec_guards():
    *_, tcfg, tp = _models("mha")
    with pytest.raises(ValueError, match="greedy"):
        tsched.ContinuousBatchingEngine(tcfg, tp, batch=2, max_len=64,
                                        temperature=0.5, spec_decode="ngram",
                                        device="cpu")
    with pytest.raises(ValueError, match="off/ngram/doc"):
        tsched.ContinuousBatchingEngine(tcfg, tp, batch=2, max_len=64,
                                        spec_decode="medusa", device="cpu")
