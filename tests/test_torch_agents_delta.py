"""The port's agent trial against the JAX package, on the CPU: the delta
merge on the dense replay cache, and sequential on int8 pools, held as
``torch_agents_common`` says.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
from test_torch_jax_state import _jax_state_from_copies  # noqa: E402,F401
from torch_agents_common import (CASES, hold_trial_to_jax,  # noqa: E402,F401
                                 one_thread, sim)

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("case", [
    "par-dense-replay-delta",
    "seq-paged-chunked-int8-delta"])
def test_trial_matches_jax(sim, case, monkeypatch):
    hold_trial_to_jax(sim, CASES[case], monkeypatch)
