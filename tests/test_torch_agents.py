"""The port's agent trial against the JAX package, on the CPU.

``run_task`` runs in both packages with the same ``make_sim_llm`` weights
(``params_from_jax``) on ``tic_tac_toe``.  Every model step of both trials
is recorded through a patched step factory (inputs and logits).  The
counters that follow from the schedule alone must be equal, and both runs
converge.  The token-dependent results (digest, semantic conflicts,
declared symbols, shared prefix pages) must be equal too, unless the
steps show a near-tie: walking both step records in lockstep while their
inputs agree, the first position whose greedy token differs must have a
JAX top-1/top-2 logit gap of at most ``TIE_GAP``.  (The bf16 sim-LLM has
exact and near ties; the frameworks round bf16 at different places, so a
tie may break either way and the streams then part.)  One more trial
runs the MLA model (reduced deepseek-v2-lite-16b with dense FFNs) on int8
latent pools with the delta merge, and one the recurrent model (reduced
recurrentgemma-2b: RG-LRU and local attention) paged and chunked, each
held the same way.

One case runs the replicated page table (``--replicas 2
--disaggregate``).  Also: ``PrefixPageMapper`` against JAX's over a
map/free sequence, the evaluator's report and reconciliation on a
converged document, and the options the port does not run yet.
"""
from __future__ import annotations

from dataclasses import asdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.agents import evaluator as jeval  # noqa: E402
from repro.agents import orchestrator as jorch  # noqa: E402
from repro.agents.tasks import TASKS as JTASKS  # noqa: E402
from repro.core import doc as jdoc  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.agents import evaluator as teval  # noqa: E402
from repro_torch.agents import orchestrator as torch_orch  # noqa: E402
from repro_torch.agents.tasks import TASKS as TTASKS  # noqa: E402
from repro_torch.core import doc as tdoc  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402

# A greedy token may differ only where JAX's top-1/top-2 gap is at most
# this: 8 bf16 steps (2^-6) at the sim-LLM's |logits| <= 4.  Measured
# JAX-vs-port logit differences at equal inputs: <= 0.035 (bf16, int8
# pools), <= 0.11 (fp8 pools); flips seen at gaps 0, 2^-6 and 2^-5.
TIE_GAP = 0.125
# Results that follow from the generated tokens (prompts replay them), so
# a near-tie flip may move them; cross-replica hits and page-gossip bytes
# follow from the prompts like the shared pages.
TOKEN_DEPENDENT = {"digest", "semantic_conflicts", "declared_symbols",
                   "shared_prefix_pages", "cross_replica_prefix_hits",
                   "page_sync_bytes", "wall_s"}


@pytest.fixture(scope="module")
def sim():
    jcfg, jp = jorch.make_sim_llm(0)
    tcfg = tconfigs.reduced(tconfigs.get("olmo-1b"), d_model=64,
                            vocab=512).replace(num_layers=2)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    return jcfg, jp, tcfg, tp


def _jax_factories(log):
    """Step factories for JAX's run_task that also record each step's
    inputs and logits (the orchestrator jits them; the callback is
    ordered)."""
    def note(kind):
        def cb(*arrs):
            *inputs, logits = (np.asarray(a) for a in arrs)
            log.append((kind, inputs, np.asarray(logits, np.float32)))
        return cb

    def serve(cfg, **_):
        def step(params, cache, token, pos, key=None):
            logits, cache = jlm.decode_step(params, cfg, token, cache, pos)
            jax.debug.callback(note("serve"), token, pos, logits,
                               ordered=True)
            return jnp.argmax(logits, -1).astype(jnp.int32), cache, pos + 1
        return step

    def mixed(cfg, **_):
        def step(params, cache, tokens, start, span, key=None):
            logits, cache = jlm.mixed_step(params, cfg, tokens, cache, start,
                                           span)
            jax.debug.callback(note("mixed"), tokens, start, span, logits,
                               ordered=True)
            return jnp.argmax(logits, -1).astype(jnp.int32), cache
        return step

    return serve, mixed


def _port_factories(log):
    def serve(cfg, **_):
        def step(params, cache, token, pos, gen=None):
            logits, cache = tlm.decode_step(params, cfg, token, cache, pos)
            log.append(("serve", [token.numpy().copy(), pos.numpy().copy()],
                        logits.float().numpy()))
            return torch.argmax(logits, -1).to(torch.int32), cache, pos + 1
        return step

    def mixed(cfg, **_):
        def step(params, cache, tokens, start, span, gen=None):
            logits, cache = tlm.mixed_step(params, cfg, tokens, cache, start,
                                           span)
            log.append(("mixed", [tokens.numpy().copy(), start.numpy().copy(),
                                  span.numpy().copy()],
                        logits.float().numpy()))
            return torch.argmax(logits, -1).to(torch.int32), cache
        return step

    return serve, mixed


def _first_flips(jlog, tlog):
    """Walk both step records while their inputs agree; return every
    (step, row, JAX gap, |logit diff|) where the greedy tokens differ.
    Span-0 rows of a mixed step are idle (their logits are not used)."""
    # JAX's run_task warms up its jitted steps first: one serve step, then
    # one all-zero-span mixed step per width bucket.  The port has no
    # warm-up.
    jlog = jlog[1:]
    while jlog and jlog[0][0] == "mixed" and not jlog[0][1][2].any():
        jlog = jlog[1:]
    assert len(jlog) == len(tlog)
    flips = []
    for i, ((kj, ij, lj), (kt, it, lt)) in enumerate(zip(jlog, tlog)):
        assert kj == kt
        if not all(np.array_equal(a, b) for a, b in zip(ij, it)):
            break                               # the runs have parted
        rows = np.ones(len(lj), bool) if kj == "serve" else ij[2] > 0
        top2 = np.sort(lj, axis=-1)[:, -2:]
        for r in np.nonzero(rows & (lj.argmax(-1) != lt.argmax(-1)))[0]:
            flips.append((i, int(r), float(top2[r, 1] - top2[r, 0]),
                          float(np.abs(lj[r] - lt[r]).max())))
    return flips


CASES = {
    "seq-dense-replay-allgather": dict(mode="sequential"),
    "par-dense-replay-allgather": dict(mode="parallel"),
    "par-dense-replay-pmax": dict(mode="parallel", merge="pmax",
                                  n_agents=2),
    "par-dense-replay-delta": dict(mode="parallel", merge="delta"),
    "seq-paged-chunked-allgather": dict(mode="sequential", kv="paged",
                                        prefill="chunked"),
    "par-paged-chunked-allgather": dict(mode="parallel", kv="paged",
                                        prefill="chunked"),
    "par-paged-chunked-pmax": dict(mode="parallel", kv="paged",
                                   prefill="chunked", merge="pmax",
                                   n_agents=2),
    "par-paged-chunked-delta": dict(mode="parallel", kv="paged",
                                    prefill="chunked", merge="delta"),
    "par-paged-chunked-int8": dict(mode="parallel", kv="paged",
                                   prefill="chunked", kv_quant="int8"),
    "seq-paged-chunked-int8-delta": dict(mode="sequential", kv="paged",
                                         prefill="chunked", kv_quant="int8",
                                         merge="delta"),
    "par-paged-chunked-fp8-delta": dict(mode="parallel", kv="paged",
                                        prefill="chunked", kv_quant="fp8",
                                        merge="delta"),
    # The replicated page table (2 metadata replicas gossiping at every
    # sync), disaggregated homes: page_sync_bytes and cross-replica hits
    # equal JAX's.
    "par-paged-chunked-replicas2-disagg": dict(
        mode="parallel", kv="paged", prefill="chunked", replicas=2,
        disaggregate=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_trial_matches_jax(sim, case, monkeypatch):
    _hold_trial_to_jax(sim, CASES[case], monkeypatch)


def _hold_trial_to_jax(models, case, monkeypatch):
    jcfg, jp, tcfg, tp = models
    kw = dict(n_agents=3, page_size=16, chunk_size=32)
    kw.update(case)
    jlog, tlog = [], []
    serve, mixed = _jax_factories(jlog)
    monkeypatch.setattr(jengine, "make_serve_step", serve)
    monkeypatch.setattr(jengine, "make_mixed_step_fn", mixed)
    serve, mixed = _port_factories(tlog)
    monkeypatch.setattr(tengine, "make_serve_step", serve)
    monkeypatch.setattr(tengine, "make_mixed_step_fn", mixed)
    rj = jorch.run_task(jcfg, jp, JTASKS["tic_tac_toe"], **kw)
    rt = torch_orch.run_task(tcfg, tp, TTASKS["tic_tac_toe"], device="cpu",
                             **kw)
    assert rj.converged and rt.converged
    dj, dt = vars(rj), vars(rt)
    for k in dj:
        if k not in TOKEN_DEPENDENT:
            assert dj[k] == dt[k], (k, dj[k], dt[k])
    flips = _first_flips(jlog, tlog)
    if any(dj[k] != dt[k] for k in TOKEN_DEPENDENT - {"wall_s"}):
        assert flips, "results differ but no greedy token differed"
    for step, row, gap, diff in flips:
        assert gap <= TIE_GAP, (
            f"greedy token differs at step {step} row {row} with JAX "
            f"top-2 gap {gap} (logit diff {diff}): not a near-tie")


@pytest.fixture(scope="module")
def mla_sim():
    """Reduced deepseek-v2-lite-16b with dense FFNs (MLA blocks), JAX's
    bf16 ``lm.init`` weights in both packages."""
    jcfg, tcfg = (pkg.reduced(pkg.get("deepseek-v2-lite-16b"), layers=2,
                              d_model=32, vocab=128).replace(
        block_pattern=("mla",), moe=None) for pkg in (jconfigs, tconfigs))
    jp = jax.jit(jlm.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    return jcfg, jp, tcfg, tp


def test_mla_trial_matches_jax(mla_sim, monkeypatch):
    """The trial on the MLA model: paged latent pools in int8, chunked
    admission (paged_mla_chunk_quant), the outliner's decode steps
    (paged_mla_decode_quant) and the delta merge; held as the cases
    above."""
    _hold_trial_to_jax(mla_sim, dict(mode="parallel", kv="paged",
                                     prefill="chunked", kv_quant="int8",
                                     merge="delta"), monkeypatch)


@pytest.fixture(scope="module")
def recurrent_sim():
    """Reduced recurrentgemma-2b (rglru, rglru, local and a tail of rglru,
    rglru; d_model 64, vocab 512), JAX's bf16 ``lm.init`` weights (float32
    log_lambda) in both packages."""
    jcfg, tcfg = (pkg.reduced(pkg.get("recurrentgemma-2b"), vocab=512)
                  for pkg in (jconfigs, tconfigs))
    jp = jax.jit(jlm.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    return jcfg, jp, tcfg, tp


def test_recurrent_trial_matches_jax(recurrent_sim, monkeypatch):
    """The trial on the recurrent model: parallel, paged (no layer holds a
    pool: the mapper's accounting only), chunked admission through the
    recurrent layers' ragged forward; held as the cases above."""
    _hold_trial_to_jax(recurrent_sim, dict(mode="parallel", kv="paged",
                                           prefill="chunked"), monkeypatch)


def test_prefix_page_mapper_matches_jax():
    """map_row / free_row over prompts that share a task header: host
    tables, shared-page counts and refcounts equal JAX's."""
    rng = np.random.default_rng(0)
    header = [int(t) for t in rng.integers(2, 500, 40)]
    ps, maxp, rows = 8, 8, 3
    mappers = [cls(rows, maxp, ps, trash_page=(rows + 1) * maxp)
               for cls in (jsched.PrefixPageMapper, tsched.PrefixPageMapper)]
    for _ in range(24):
        row = int(rng.integers(0, rows))
        if rng.random() < 0.2:
            for m in mappers:
                m.free_row(row)
        else:
            toks = header[:int(rng.integers(8, 40))] + [
                int(t) for t in rng.integers(2, 500, int(rng.integers(0, 9)))]
            horizon = len(toks) + int(rng.integers(1, 20))
            got = [m.map_row(row, toks, horizon) for m in mappers]
            assert got[0] == got[1]
        np.testing.assert_array_equal(mappers[0].host_bt, mappers[1].host_bt)
        assert mappers[0].shared_pages == mappers[1].shared_pages
        np.testing.assert_array_equal(mappers[0].allocator._ref,
                                      mappers[1].allocator._ref)
    assert mappers[1].shared_pages > 0
    cache = tlm.init_cache(
        tconfigs.reduced(tconfigs.get("olmo-1b"), d_model=32, vocab=64),
        rows, maxp * ps, paged=True, page_size=ps,
        num_pages=(rows + 1) * maxp + 1, kv_quant="int8", device="cpu")
    cache = mappers[1].install(cache)
    np.testing.assert_array_equal(
        tlm.get_block_tables(cache).numpy(), mappers[1].host_bt)


def _converged_doc(seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, size=(8, 64)).astype(np.int32)
    toks[3, 5] = toks[0, 2] = 5 + 13 * 7          # a duplicate declaration
    lengths = rng.integers(10, 64, 8).astype(np.int32)
    owner = np.arange(1, 9, dtype=np.int32)
    return (jdoc.SlotDoc(*(jnp.asarray(a) for a in (toks, lengths, owner))),
            tdoc.SlotDoc(*(torch.as_tensor(a) for a in (toks, lengths,
                                                        owner))))


@pytest.mark.parametrize("seed", [0, 1])
def test_evaluator_matches_jax(seed):
    jd, td = _converged_doc(seed)
    rj, rt = jeval.scan(jd), teval.scan(td)
    assert rj.conflicts and asdict(rj) == asdict(rt)
    (jfixed, jrep), (tfixed, trep) = jeval.reconcile(jd), teval.reconcile(td)
    assert asdict(jrep) == asdict(trep) and jrep.fixed > 0
    for a, b in zip(jfixed, tfixed):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert jeval.score(jfixed) == teval.score(tfixed)
    assert jorch.count_conflicts(jd) == torch_orch.count_conflicts(td)


def test_options_not_ported_raise(sim):
    *_, tcfg, tp = sim
    task = TTASKS["tic_tac_toe"]
    with pytest.raises(NotImplementedError, match="item 8"):
        torch_orch.run_task(tcfg, tp, task, mode="parallel", kv="paged",
                            prefill="chunked", spec_decode="ngram",
                            device="cpu")
    # --replicas / --disaggregate are ported (queue 1 item 12): what is
    # left are their argument checks, as in JAX.
    with pytest.raises(ValueError, match="requires the paged KV cache"):
        torch_orch.run_task(tcfg, tp, task, mode="parallel", replicas=2,
                            device="cpu")
    with pytest.raises(ValueError, match="--disaggregate requires"):
        torch_orch.run_task(tcfg, tp, task, mode="parallel", kv="paged",
                            disaggregate=True, device="cpu")
    with pytest.raises(ValueError, match="requires --kv paged"):
        torch_orch.run_task(tcfg, tp, task, mode="parallel",
                            kv_quant="int8", device="cpu")
    with pytest.raises(ValueError, match="params live on"):
        torch_orch.run_task(tcfg, tp, task, mode="parallel",
                            device="meta")
