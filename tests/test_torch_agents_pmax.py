"""The port's agent trial against the JAX package, on the CPU: the pmax
merge (dense replay and paged chunked, two agents) and the replicated page
table (``--replicas 2 --disaggregate``: 2 metadata replicas gossiping at
every sync, disaggregated homes; page_sync_bytes and cross-replica hits
equal JAX's), held as ``torch_agents_common`` says.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
from test_torch_jax_state import _jax_state_from_copies  # noqa: E402,F401
from torch_agents_common import (CASES, hold_trial_to_jax,  # noqa: E402,F401
                                 one_thread, sim)

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("case", [
    "par-dense-replay-pmax",
    "par-paged-chunked-pmax",
    "par-paged-chunked-replicas2-disagg"])
def test_trial_matches_jax(sim, case, monkeypatch):
    hold_trial_to_jax(sim, CASES[case], monkeypatch)
