"""Replica merge strategies: "the collective IS the relay".

Every CRDT here is a join-semilattice whose join is an elementwise (masked)
max, so replicas converge through a collective over the replica axis
instead of a message relay.  Three strategies, line for line with JAX's
``merge.py``:

  * ``allgather_merge``: gather all N replicas, fold the exact join
    locally; O(N·S) bytes (the paper's every-agent-observes-everyone);
  * ``pmax_merge``: the join as elementwise maxes (G-types a masked max;
    LWW banks the max of the packed (clock, client) key, then a masked max
    per payload field); O(S) bytes;
  * ``delta_merge``: each replica extracts its ops beyond a shared
    frontier into a fixed-capacity buffer, the buffers circulate the
    replica ring (N-1 shifts, each hop joined), and the new frontier is
    the min over the replicas; O(Δ) bytes.

A replica axis is a small interface, what JAX's ``lax`` collectives give
inside ``shard_map``: ``max`` / ``min`` (all-reduce, shaped like the
input), ``all_gather`` (each replica gets the axis' members stacked on a
new axis), ``shift`` (``ppermute`` with ``perm = [(i, (i+1) % n)]``) and
``size``.  It has two routes:

  * ``StackedAxis``: the replicas stacked on the leading dim of every
    leaf in one process (what JAX's ``vmap(..., axis_name=)`` computes);
    a grid of several axes is stacked row-major on that one dim;
  * ``GroupAxis``: one replica a rank over ``torch.distributed`` (gloo on
    the CPU, NCCL on the card), the group of one axis of a ``DeviceMesh``.

Either way a state's leaves carry a leading dim with the replicas this
process holds: all R on the stacked route, 1 (the rank's own, as
``shard_map`` hands a block) on a rank.  Several axes (JAX's
``axis_names=("pod", "data")``) compose axis by axis: a join over the
first axis then over the next is the join over both, and for the delta
ring it is what JAX does, one ring per axis in order.

The orchestrator folds its agents' replicas with ``fold_join`` or syncs
them with ``delta.DeltaSync`` (single host, host lists).
"""
from __future__ import annotations

import functools
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.core import counter as counter_mod
from repro_torch.core import delta as delta_mod
from repro_torch.core import doc as doc_mod
from repro_torch.core import gset, lww, rga, todo, tree
from repro_torch.core.clock import unpack_key

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
# Replica axes: the stacked route and the process-group route
# ---------------------------------------------------------------------------

class StackedAxis:
    """Axis ``dim`` of a replica grid ``grid`` whose replicas are stacked,
    row-major, on the leading dim of every leaf in one process (leaves
    [prod(grid), ...]; replica ``r`` of a grid (A, B) is (r // B, r % B),
    as ``shard_map`` lays blocks out over ``P(("a", "b"))``).  Every output
    is a new tensor, one row a replica: each replica owns its storage, as
    after a collective, so writing one replica never writes another."""

    def __init__(self, grid: tuple[int, ...], dim: int = 0):
        self.grid = tuple(grid)
        self.dim = dim
        self.size = self.grid[dim]

    def _grid(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(self.grid + tuple(x.shape[1:]))

    def _reduce(self, x: torch.Tensor, fn) -> torch.Tensor:
        g = self._grid(x)
        return fn(g, self.dim, keepdim=True).expand_as(g).clone().reshape(
            x.shape)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, torch.amax)

    def min(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, torch.amin)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[R, ...] -> [R, n, ...]: each replica gets its axis' n members
        in axis order."""
        g = self._grid(x)
        rest = tuple(x.shape[1:])
        t = g.movedim(self.dim, len(self.grid) - 1).unsqueeze(self.dim)
        return t.expand(self.grid + (self.size,) + rest).clone().reshape(
            (x.shape[0], self.size) + rest)

    def shift(self, x: torch.Tensor) -> torch.Tensor:
        """Replica i of the axis receives replica i - 1's ``x``."""
        return torch.roll(self._grid(x), 1, self.dim).reshape(x.shape)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the collectives move it: contiguous, bool as uint8."""
    x = x.contiguous()
    return x.view(torch.uint8) if x.dtype == torch.bool else x


def _unwire(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.view(torch.bool) if dtype == torch.bool else x


class GroupAxis:
    """One replica a rank over ``torch.distributed``: the ranks of
    ``group`` (gloo on the CPU, NCCL on the card; ``DeviceMesh
    .get_group(name)`` for one mesh axis) in group-rank order.  Leaves
    carry the rank's own replica on a leading dim of 1."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        me = dist.get_rank(group)
        self._next = dist.get_global_rank(group, (me + 1) % self.size)
        self._prev = dist.get_global_rank(group, (me - 1) % self.size)

    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        out = x.clone()
        dist.all_reduce(out, op=op, group=self.group)
        return out

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.MAX)

    def min(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.MIN)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[1, ...] -> [1, n, ...] (the list form of ``all_gather``, which
        every PyTorch version has)."""
        src = _wire(x)
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return _unwire(torch.stack(parts, 1), x.dtype)

    def shift(self, x: torch.Tensor) -> torch.Tensor:
        """Send ``x`` to the next rank of the group, receive the previous
        rank's (JAX's ``ppermute`` with ``perm = [(i, (i+1) % n)]``)."""
        src = _wire(x)
        out = torch.empty_like(src)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, src, self._next, self.group),
                dist.P2POp(dist.irecv, out, self._prev, self.group)]):
            req.wait()
        return _unwire(out, x.dtype)


def _axes(axis) -> tuple:
    """One axis, or several (joined over in order)."""
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def per_replica(fn: Callable, *trees: Any) -> Any:
    """``fn`` on each replica's slice of ``trees`` (the leading dim of
    every leaf), the results stacked back: the replica-local part of a
    collective merge (JAX's body inside ``shard_map`` or ``vmap``)."""
    n = tree.leaves(trees[0])[0].shape[0]
    outs = [fn(*(tree.map(lambda x, r=r: x[r], t) for t in trees))
            for r in range(n)]
    return tree.map(lambda *xs: torch.stack(xs), outs[0], *outs[1:])


# ---------------------------------------------------------------------------
# The collective merges
# ---------------------------------------------------------------------------

def allgather_merge(state: Any, axis) -> Any:
    """Paper-faithful: every replica observes every replica, folds
    locally."""
    for ax in _axes(axis):
        gathered = tree.map(ax.all_gather, state)
        state = per_replica(tree_join_stacked, gathered)
    return state


def _pmax(x: torch.Tensor, axis) -> torch.Tensor:
    if x.dtype == torch.bool:
        return _pmax(x.to(torch.int32), axis).to(torch.bool)
    for ax in _axes(axis):
        x = ax.max(x)
    return x


def _masked_pmax(x: torch.Tensor, valid: torch.Tensor, axis) -> torch.Tensor:
    """The max where invalid lanes contribute the identity (-inf /
    INT_MIN)."""
    v = valid.reshape(valid.shape + (1,) * (x.dim() - valid.dim()))
    if x.dtype == torch.bool:
        # Non-winners contribute False, so OR returns exactly the winner's
        # bits.
        return _pmax(x & v, axis)
    if x.dtype.is_floating_point:
        neutral = torch.tensor(float("-inf"), dtype=x.dtype,
                               device=x.device)
    else:
        neutral = torch.tensor(torch.iinfo(x.dtype).min, dtype=x.dtype,
                               device=x.device)
    out = _pmax(torch.where(v, x, neutral), axis)
    # Lanes no replica has observed keep their (identical) local default,
    # so the merged state is bit-equal to the fold join.  Payloads never
    # carry the neutral value themselves (tokens/clocks/lengths are >= -1).
    return torch.where(out == neutral, x, out)


def _pmax_lww(bank: lww.LWWBank, axis) -> lww.LWWBank:
    key = bank.key
    win_key = _pmax(key, axis)
    i_win = key == win_key
    payload = {name: _masked_pmax(arr, i_win, axis)
               for name, arr in bank.payload.items()}
    clock, client = unpack_key(win_key)
    return lww.LWWBank(clock=clock, client=client, payload=payload)


def _pmax_merge_axis(state: Any, axis) -> Any:
    t = type(state)
    if t is lww.LWWBank:
        return _pmax_lww(state, axis)
    if t is todo.TodoBoard:
        return todo.TodoBoard(_pmax_lww(state.bank, axis))
    if t in (gset.GCounter, gset.GSet, counter_mod.PNCounter):
        return tree.map(lambda x: _pmax(x, axis), state)
    if t is gset.GLog:
        valid = state.valid_mask()
        fields = {k: _masked_pmax(v, valid, axis)
                  for k, v in state.fields.items()}
        return gset.GLog(count=_pmax(state.count, axis), fields=fields)
    if t is rga.RGA:
        valid = state.valid_mask()
        return rga.RGA(
            count=_pmax(state.count, axis),
            op_clock=_masked_pmax(state.op_clock, valid, axis),
            origin=_masked_pmax(state.origin, valid, axis),
            token=_masked_pmax(state.token, valid, axis),
            deleted=_pmax(state.deleted, axis))
    if t is doc_mod.SlotDoc:
        valid = doc_mod.valid_mask(state)
        return doc_mod.SlotDoc(
            tokens=_masked_pmax(state.tokens, valid, axis),
            length=_pmax(state.length, axis),
            owner=_pmax(state.owner, axis))
    if not isinstance(state, (dict, list, tuple)):
        raise TypeError(f"no join for {type(state).__name__}")
    # Container: recurse into CRDT nodes.
    return tree.map(lambda s: _pmax_merge_axis(s, axis), state,
                    is_leaf=is_crdt)


def pmax_merge(state: Any, axis) -> Any:
    """O(S)-byte join as elementwise maxes (JAX ``merge.pmax_merge``):

      * G-types (counter / set / log / RGA / SlotDoc): the masked
        elementwise max is the join itself;
      * LWW banks: the max of the packed (clock, client) key picks the
        winner, then a masked max carries each payload field (exact since
        (clock, client) pairs are unique across writers).

    ``axis``: a replica axis or a tuple of them.  Every replica gets the
    join."""
    for ax in _axes(axis):
        state = _pmax_merge_axis(state, ax)
    return state


def _pmin(x: torch.Tensor, axis) -> torch.Tensor:
    if x.dtype == torch.bool:
        # AND across replicas: only bits everyone has set survive.
        return ~_pmax(~x, axis)
    for ax in _axes(axis):
        x = ax.min(x)
    return x


def delta_merge(state: Any, frontier: Any, axis, *,
                capacity: Any = 64) -> tuple[Any, Any]:
    """Delta-state ring sync across the replica axis (JAX
    ``merge.delta_merge``; the axis sizes come with the axes).

    ``frontier`` must be the SHARED frontier of the previous sync round
    (the same on every replica; initially ``delta.frontier(initial)``
    replicated).  Each replica extracts its delta beyond the frontier, the
    deltas circulate the ring in N-1 shifts, and each hop joins the
    received delta.  Several axes sync as one ring per axis, in order:
    after the first ring every member of that axis agrees, so the next
    ring forwards the combined deltas.

    Returns ``(merged_state, new_frontier)``.  The new frontier is the min
    over every axis of each replica's post-merge watermark: exactly the
    ops that reached EVERY replica, so anything that overflowed
    ``capacity`` on some hop stays ahead of it and ships next round."""
    axes = _axes(axis)
    for ax in axes:
        d, _ = per_replica(
            lambda s, f: delta_mod.extract(s, f, capacity), state, frontier)
        for _ in range(ax.size - 1):
            d = tree.map(ax.shift, d)
            state = per_replica(delta_mod.apply, state, d)
    new_frontier = tree.map(lambda x: _pmin(x, axes),
                            delta_mod.frontier(state))
    return state, new_frontier


def collective_merge(state: Any, axis, strategy: str = "pmax") -> Any:
    if strategy == "pmax":
        return pmax_merge(state, axis)
    if strategy == "allgather":
        return allgather_merge(state, axis)
    if strategy == "delta":
        raise ValueError(
            "delta merge threads a frontier — call merge.delta_merge (or "
            "engine.make_coord_merge(strategy='delta')) instead")
    raise ValueError(f"unknown merge strategy: {strategy}")
