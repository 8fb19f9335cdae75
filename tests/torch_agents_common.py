"""Shared pieces of the port's agent-trial tests against the JAX package
(``tests/test_torch_agents*.py``), on the CPU.

``run_task`` runs in both packages with the same weights
(``params_from_jax``) on ``tic_tac_toe``.  Every model step of both trials
is recorded through a patched step factory (inputs and logits).  The
counters that follow from the schedule alone must be equal, and both runs
converge.  The token-dependent results (digest, semantic conflicts,
declared symbols, shared prefix pages) must be equal too, unless the
steps show a near-tie: walking both step records in lockstep while their
inputs agree, the first position whose greedy token differs must have a
JAX top-1/top-2 logit gap of at most ``TIE_GAP``.  (The bf16 sim-LLM has
exact and near ties; the frameworks round bf16 at different places, so a
tie may break either way and the streams then part.)

The trial cases (``CASES``) are spread over several files so that a run
that distributes files over workers (``--dist loadfile``) spreads them;
each file parametrizes ``test_trial_matches_jax`` over its own share.
The models are fixtures here (``sim``, ``mla_sim``, ``recurrent_sim``),
as is ``one_thread``: the models are 32–64 wide, and one intra-op thread
runs their trials as fast and leaves the cores to the run's other
workers.  A file imports the fixtures it uses, and
``test_torch_jax_state._jax_state_from_copies`` (JAX's
``ReplicatedPageStore`` state built from host copies: its ``jnp.asarray``
aliases the store's numpy buffers and the delta extract runs
asynchronously, so a JAX packet could read writes made after it was made).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.agents import orchestrator as jorch  # noqa: E402
from repro.agents.tasks import TASKS as JTASKS  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.agents import orchestrator as torch_orch  # noqa: E402
from repro_torch.agents.tasks import TASKS as TTASKS  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def hold_trial_to_jax(models, case, monkeypatch):
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
