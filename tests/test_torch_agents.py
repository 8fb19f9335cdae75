"""The port's agent trial against the JAX package, on the CPU: the
all-gather cases, the MLA and recurrent models' trials, and the pieces
around the trial.

The trial cases are held as ``torch_agents_common`` says (schedule
counters equal, both converge, token-dependent results equal unless a
greedy token differs at a JAX top-2 gap of at most ``TIE_GAP``); the other
cases live in ``test_torch_agents_{pmax,delta,paged,quant}.py``.  One more
trial runs the MLA model (reduced deepseek-v2-lite-16b with dense FFNs) on
int8 latent pools with the delta merge, and one the recurrent model
(reduced recurrentgemma-2b: RG-LRU and local attention) paged and chunked,
each held the same way.  Also: ``PrefixPageMapper`` against JAX's over a
map/free sequence, the evaluator's report and reconciliation on a
converged document, and the options' argument checks.
"""
from __future__ import annotations

from dataclasses import asdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.agents import evaluator as jeval  # noqa: E402
from repro.agents import orchestrator as jorch  # noqa: E402
from repro.core import doc as jdoc  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.agents import evaluator as teval  # noqa: E402
from repro_torch.agents import orchestrator as torch_orch  # noqa: E402
from repro_torch.agents.tasks import TASKS as TTASKS  # noqa: E402
from repro_torch.core import doc as tdoc  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402
from test_torch_jax_state import _jax_state_from_copies  # noqa: E402,F401
from torch_agents_common import (CASES, hold_trial_to_jax,  # noqa: E402,F401
                                 mla_sim, one_thread, recurrent_sim, sim)

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("case", [
    "par-dense-replay-allgather",
    "seq-dense-replay-allgather",
    "seq-paged-chunked-allgather"])
def test_trial_matches_jax(sim, case, monkeypatch):
    hold_trial_to_jax(sim, CASES[case], monkeypatch)


def test_mla_trial_matches_jax(mla_sim, monkeypatch):
    """The trial on the MLA model: paged latent pools in int8, chunked
    admission (paged_mla_chunk_quant), the outliner's decode steps
    (paged_mla_decode_quant) and the delta merge; held as the cases
    above."""
    hold_trial_to_jax(mla_sim, dict(mode="parallel", kv="paged",
                                     prefill="chunked", kv_quant="int8",
                                     merge="delta"), monkeypatch)


def test_recurrent_trial_matches_jax(recurrent_sim, monkeypatch):
    """The trial on the recurrent model: parallel, paged (no layer holds a
    pool: the mapper's accounting only), chunked admission through the
    recurrent layers' ragged forward; held as the cases above."""
    hold_trial_to_jax(recurrent_sim, dict(mode="parallel", kv="paged",
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


def test_options_check_their_arguments(sim):
    *_, tcfg, tp = sim
    task = TTASKS["tic_tac_toe"]
    # --spec-decode is ported (queue 1 item 8): it rides the mixed step,
    # so without chunked prefill it raises JAX's guard.
    with pytest.raises(ValueError, match="mixed serve step"):
        torch_orch.run_task(tcfg, tp, task, mode="parallel", kv="paged",
                            prefill="replay", spec_decode="ngram",
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
