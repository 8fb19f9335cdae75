"""The shared fixture that builds JAX's ``ReplicatedPageStore`` state from
host copies, for every port test that runs the JAX replicated page table
(``test_torch_replicated.py``, ``test_torch_fault_tolerance.py``,
``test_torch_disagg.py``, ``test_torch_agents.py``), and the test that
shows the alias it removes is gone.

``ReplicatedPageStore.state`` wraps the store's working numpy arrays with
``jnp.asarray``, which aliases a 64-byte-aligned buffer on the CPU, and the
jitted delta extract runs asynchronously.  So a packet made by
``AntiEntropyNode.make_packet`` could read a heartbeat or refcount that the
simulator or the server wrote in place after ``make_packet`` returned.
Whether it did depended on allocator alignment and CPU load: under load
the JAX simulator's converged digest and the chaos harness's traces
changed from run to run (ROADMAP.md queue 3).  With the state built from
copies, a delta reads the store as it was when extracted.

A file uses it by importing the fixture, which is module-scoped and
autouse, so the patch is in force for the module's fixtures too (JAX runs
cached at module scope included):

    from test_torch_jax_state import _jax_state_from_copies  # noqa: F401
"""
from __future__ import annotations

import copy

import numpy as np
import pytest

pytest.importorskip("torch")
import jax  # noqa: E402

from repro.serving import replicated as jrep  # noqa: E402

_STATE = jrep.ReplicatedPageStore.state


def state_from_copies(store) -> dict:
    """JAX's ``ReplicatedPageStore.state`` of ``store``, built from host
    copies of its working arrays (top-level arrays and dicts of arrays), so
    no JAX array aliases a buffer the store later writes in place."""
    snap = copy.copy(store)
    for name, val in vars(store).items():
        if isinstance(val, np.ndarray):
            setattr(snap, name, val.copy())
        elif isinstance(val, dict):
            setattr(snap, name, {k: v.copy() if isinstance(v, np.ndarray)
                                 else v for k, v in val.items()})
    return _STATE(snap)


@pytest.fixture(scope="module", autouse=True)
def _jax_state_from_copies():
    """``ReplicatedPageStore.state`` patched to ``state_from_copies`` for
    the whole module that imports this fixture."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrep.ReplicatedPageStore, "state", state_from_copies)
        yield


def test_packet_does_not_see_a_later_in_place_write():
    """A delta packet made before the store writes its arrays in place
    (refcount lanes, heartbeats, a lease) carries the state of the moment
    it was made: the peer that applies it after the writes sees the old
    values, and the state handed to JAX shares no buffer with the store."""
    assert jrep.ReplicatedPageStore.state is state_from_copies
    stores = [jrep.ReplicatedPageStore(i, 2, 64) for i in range(2)]
    nodes = [jrep.AntiEntropyNode(s) for s in stores]
    src = stores[0]
    src.ref_add(3)
    src.heartbeat(1)
    state = src.state()
    pkt = nodes[0].make_packet(1, now=1)
    # In-place writes after the packet was made, before anything waits on
    # the asynchronous extract.
    src.ref_add(3, 5)
    src.heartbeat(9)
    src.lease_write(7, 0, 4)
    src.inc[...] += 100
    src.hb[...] += 100
    nodes[1].receive(pkt, now=2)
    dst = stores[1]
    assert dst.refcount(3) == 1
    assert int(dst.hb[0]) == 1
    assert dst.lease(7) == (-1, 0)
    jax.block_until_ready(state)
    assert int(np.asarray(state["ref"].inc)[0, 3]) == 1
    assert int(np.asarray(state["hb"].counts)[0]) == 1
    for arr in jax.tree.leaves(state):
        host = np.asarray(arr)
        assert not any(np.shares_memory(host, v) for v in vars(src).values()
                       if isinstance(v, np.ndarray))


def test_fixture_is_applied_where_jax_runs_the_replicated_table():
    """The port test files that run JAX's replicated page table import the
    fixture (a file that forgets it reads racy JAX traces); the agent
    trials' files all do."""
    from pathlib import Path
    here = Path(__file__).parent
    agents = sorted(p.name for p in here.glob("test_torch_agents*.py"))
    assert len(agents) >= 3, agents
    for name in ("test_torch_replicated.py", "test_torch_fault_tolerance.py",
                 "test_torch_disagg.py", "test_torch_bench_serving.py",
                 *agents):
        text = (here / name).read_text()
        assert ("from test_torch_jax_state import _jax_state_from_copies"
                in text), name
