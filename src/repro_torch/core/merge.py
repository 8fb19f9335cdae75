"""Replica merge: local joins of replica states.

Every CRDT here is a join-semilattice whose join is an elementwise (masked)
max, so replicas merge exactly and in any order.  The orchestrator folds
its agents' replicas with ``fold_join`` (the ``allgather`` and ``pmax``
strategies of the trial differ only in their wire-cost model on a single
host) or syncs them with ``delta.DeltaSync``.  The collective merges over a
device mesh (``allgather_merge``, ``pmax_merge``, ``delta_merge``) are not
ported yet: ROADMAP.md queue 1 item 13.
"""
from __future__ import annotations

import functools
from typing import Any, Callable

from repro_torch.core import counter as counter_mod
from repro_torch.core import doc as doc_mod
from repro_torch.core import gset, lww, rga, todo, tree

_JOINS: dict[type, Callable[[Any, Any], Any]] = {
    lww.LWWBank: lww.merge,
    gset.GCounter: lambda a, b: a.join(b),
    gset.GSet: lambda a, b: a.join(b),
    gset.GLog: lambda a, b: a.join(b),
    rga.RGA: rga.merge,
    doc_mod.SlotDoc: doc_mod.merge,
    todo.TodoBoard: lambda a, b: todo.TodoBoard(lww.merge(a.bank, b.bank)),
    counter_mod.PNCounter: lambda a, b: a.join(b),
}


def is_crdt(x: Any) -> bool:
    return type(x) in _JOINS


def join(a: Any, b: Any) -> Any:
    """Pairwise join of two replica states (any registered CRDT, or a
    container whose CRDT nodes are joined atomically)."""
    fn = _JOINS.get(type(a))
    if fn is not None:
        return fn(a, b)
    if not isinstance(a, (dict, list, tuple)):
        raise TypeError(f"no join for {type(a).__name__}")
    return tree.map(join, a, b, is_leaf=is_crdt)


def fold_join(states: list[Any]) -> Any:
    """Exact join of many replicas (host-side list)."""
    return functools.reduce(join, states)


def tree_join_stacked(stacked: Any) -> Any:
    """Join replicas stacked on a leading axis."""
    n = tree.leaves(stacked)[0].shape[0]
    take = lambda i: tree.map(lambda x: x[i], stacked)
    acc = take(0)
    for i in range(1, n):
        acc = join(acc, take(i))
    return acc
