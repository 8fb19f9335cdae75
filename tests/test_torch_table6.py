"""The paper's N-agent sweep (``table6``) in the port against the JAX
package, on the CPU: a tiny sweep (agents 1 and 2, one run, on the tasks
the function names, ``tic_tac_toe`` and ``visualizer``) with JAX's sim-LLM
weights in both packages prints JAX's rows; the replay trials' step counts
follow from the schedule alone.
"""
from __future__ import annotations

import pytest

pytest.importorskip("torch")

from benchmarks import tables as jtables  # noqa: E402
from repro_torch.benchmarks import tables as ttables  # noqa: E402
from test_torch_tables import _one_thread, both, sim  # noqa: E402,F401


def test_tiny_table6_prints_jax_rows(both):
    want = jtables.table6(runs=1, agents=(1, 2))
    assert ttables.table6(runs=1, agents=(1, 2)) == want
    assert [r.split(",")[0] for r in want] == [
        f"table6/{t}/N{n}" for t in ("tic_tac_toe", "visualizer")
        for n in (1, 2)]
