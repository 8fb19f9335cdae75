"""Replica merge: local joins of replica states, and the join as one
elementwise max over a replica axis.

Every CRDT here is a join-semilattice whose join is an elementwise (masked)
max, so replicas merge exactly and in any order.  The orchestrator folds
its agents' replicas with ``fold_join`` (the ``allgather`` and ``pmax``
strategies of the trial differ only in their wire-cost model on a single
host) or syncs them with ``delta.DeltaSync``.

``pmax_merge`` is the body of JAX's ``pmax_merge`` with the collective
made a parameter: ``reduce_max(x)`` returns the elementwise max of ``x``
over the replicas, shaped like ``x``.  ``stacked_max`` is the
single-process stand-in, replicas stacked on a leading axis (what JAX's
``vmap(pmax_merge, axis_name=...)`` computes); a ``torch.distributed``
all-reduce(MAX) is the collective one.  The collectives themselves
(``allgather_merge``, ``delta_merge``, a distributed ``reduce_max``) are
not ported yet: ROADMAP.md queue 1 item 13.
"""
from __future__ import annotations

import functools
from typing import Any, Callable

import torch

from repro_torch.core import counter as counter_mod
from repro_torch.core import doc as doc_mod
from repro_torch.core import gset, lww, rga, todo, tree
from repro_torch.core.clock import unpack_key

ReduceMax = Callable[[torch.Tensor], torch.Tensor]

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


# ---------------------------------------------------------------------------
# The join as an elementwise max over a replica axis
# ---------------------------------------------------------------------------

def stacked_max(x: torch.Tensor) -> torch.Tensor:
    """Max over the replicas stacked on ``x``'s leading axis, copied back
    to every replica (each its own storage, as an all-reduce leaves it):
    the single-process ``reduce_max``."""
    return x.amax(0, keepdim=True).expand_as(x).clone()


def _pmax(x: torch.Tensor, reduce_max: ReduceMax) -> torch.Tensor:
    if x.dtype == torch.bool:
        return reduce_max(x.to(torch.int32)).to(torch.bool)
    return reduce_max(x)


def _masked_pmax(x: torch.Tensor, valid: torch.Tensor,
                 reduce_max: ReduceMax) -> torch.Tensor:
    """The max where invalid lanes contribute the identity (-inf /
    INT_MIN)."""
    v = valid.reshape(valid.shape + (1,) * (x.dim() - valid.dim()))
    if x.dtype == torch.bool:
        # Non-winners contribute False, so OR returns exactly the winner's
        # bits.
        return _pmax(x & v, reduce_max)
    if x.dtype.is_floating_point:
        neutral = torch.tensor(float("-inf"), dtype=x.dtype,
                               device=x.device)
    else:
        neutral = torch.tensor(torch.iinfo(x.dtype).min, dtype=x.dtype,
                               device=x.device)
    out = reduce_max(torch.where(v, x, neutral))
    # Lanes no replica has observed keep their (identical) local default,
    # so the merged state is bit-equal to the fold join.  Payloads never
    # carry the neutral value themselves (tokens/clocks/lengths are >= -1).
    return torch.where(out == neutral, x, out)


def _pmax_lww(bank: lww.LWWBank, reduce_max: ReduceMax) -> lww.LWWBank:
    key = bank.key
    win_key = reduce_max(key)
    i_win = key == win_key
    payload = {name: _masked_pmax(arr, i_win, reduce_max)
               for name, arr in bank.payload.items()}
    clock, client = unpack_key(win_key)
    return lww.LWWBank(clock=clock, client=client, payload=payload)


def pmax_merge(state: Any, reduce_max: ReduceMax) -> Any:
    """O(S)-byte join as elementwise maxes (JAX ``merge.pmax_merge``):

      * G-types (counter / set / log / RGA / SlotDoc): the masked
        elementwise max is the join itself;
      * LWW banks: the max of the packed (clock, client) key picks the
        winner, then a masked max carries each payload field (exact since
        (clock, client) pairs are unique across writers).

    ``reduce_max`` is the max over the replicas (``stacked_max`` for
    states stacked on a leading axis).  Every replica gets the join."""
    t = type(state)
    if t is lww.LWWBank:
        return _pmax_lww(state, reduce_max)
    if t is todo.TodoBoard:
        return todo.TodoBoard(_pmax_lww(state.bank, reduce_max))
    if t in (gset.GCounter, gset.GSet, counter_mod.PNCounter):
        return tree.map(lambda x: _pmax(x, reduce_max), state)
    if t is gset.GLog:
        valid = state.valid_mask()
        fields = {k: _masked_pmax(v, valid, reduce_max)
                  for k, v in state.fields.items()}
        return gset.GLog(count=_pmax(state.count, reduce_max),
                         fields=fields)
    if t is rga.RGA:
        valid = state.valid_mask()
        return rga.RGA(
            count=_pmax(state.count, reduce_max),
            op_clock=_masked_pmax(state.op_clock, valid, reduce_max),
            origin=_masked_pmax(state.origin, valid, reduce_max),
            token=_masked_pmax(state.token, valid, reduce_max),
            deleted=_pmax(state.deleted, reduce_max))
    if t is doc_mod.SlotDoc:
        valid = doc_mod.valid_mask(state)
        return doc_mod.SlotDoc(
            tokens=_masked_pmax(state.tokens, valid, reduce_max),
            length=_pmax(state.length, reduce_max),
            owner=_pmax(state.owner, reduce_max))
    if not isinstance(state, (dict, list, tuple)):
        raise TypeError(f"no join for {type(state).__name__}")
    # Container: recurse into CRDT nodes.
    return tree.map(lambda s: pmax_merge(s, reduce_max), state,
                    is_leaf=is_crdt)
