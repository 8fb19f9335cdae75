"""Delta-state CRDT sync: ship O(Δ) deltas instead of O(S) full state.

Every CRDT here is a join-semilattice, so a delta — a small state fragment
— merges into a replica through the same join that full states use
(Almeida et al. 2018).  For each registered CRDT:

  ``frontier(state)``   a compact watermark of what was observed/shipped:
                        per-client op counts (GLog, RGA), per-slot lengths
                        (SlotDoc), per-register packed keys (LWWBank,
                        TodoBoard), or the tiny state itself (GCounter,
                        GSet, PNCounter cells);
  ``extract(state, frontier, capacity)``
                        the ops beyond ``frontier`` in a FIXED-CAPACITY
                        buffer, plus the frontier actually shipped (overflow
                        is not lost: it ships on a later round);
  ``apply(state, delta)``
                        joins the delta into a replica (idempotent,
                        order-insensitive).

Leaves keep the JAX package's dtypes (int32, bool, uint8 bit-packs), so
``nbytes`` — the wire size the orchestrator reports — is the same number.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch

from repro_torch.core import counter as counter_mod
from repro_torch.core import doc as doc_mod
from repro_torch.core import gset, lww, rga, todo, tree
from repro_torch.core.clock import pack_key

INT32_MAX = torch.iinfo(torch.int32).max

# ---------------------------------------------------------------------------
# Frontier / delta containers
# ---------------------------------------------------------------------------


class LogFrontier(NamedTuple):
    count: torch.Tensor          # i32[C] — ops observed per client row


class KeyFrontier(NamedTuple):
    key: torch.Tensor            # i32[K] — packed (clock, client) per register


class SlotFrontier(NamedTuple):
    length: torch.Tensor         # i32[K] — tokens observed per slot


class LogDelta(NamedTuple):
    """New ops of a GLog beyond a LogFrontier, one run per client row."""

    start: torch.Tensor          # i32[C]
    num: torch.Tensor            # i32[C] — ops shipped (<= capacity)
    fields: dict[str, Any]       # field -> [C, capacity, ...]


class RGADelta(NamedTuple):
    """New ops of an RGA plus the full (bit-packed) tombstone set."""

    start: torch.Tensor          # i32[C]
    num: torch.Tensor            # i32[C]
    op_clock: torch.Tensor       # i32[C, capacity]
    origin: torch.Tensor         # i32[C, capacity]
    token: torch.Tensor          # i32[C, capacity]
    deleted_bits: torch.Tensor   # u8[C, ceil(L/8)] — tombstones OR on apply


class LWWDelta(NamedTuple):
    """Changed registers of an LWWBank, left-packed into ``capacity`` lanes
    (``idx`` = -1 for empty lanes; each register at most once)."""

    idx: torch.Tensor            # i32[capacity]
    clock: torch.Tensor          # i32[capacity]
    client: torch.Tensor         # i32[capacity]
    payload: dict[str, Any]      # field -> [capacity, ...]


class SlotDelta(NamedTuple):
    """New tokens of a SlotDoc beyond a SlotFrontier, one run per slot."""

    start: torch.Tensor          # i32[K]
    num: torch.Tensor            # i32[K]
    tokens: torch.Tensor         # i32[K, capacity]
    owner: torch.Tensor          # i32[K] — joins by max (shipped whole)


class CounterDelta(NamedTuple):
    counts: torch.Tensor         # i32[C] — the state IS the watermark


class SetDelta(NamedTuple):
    bits: torch.Tensor           # u8[ceil(N/8)] — bit-packed membership


class PNFrontier(NamedTuple):
    inc: torch.Tensor            # i32[R, K] — cell values observed/shipped
    dec: torch.Tensor            # i32[R, K]


class PNDelta(NamedTuple):
    """Changed cells of a PNCounter, left-packed into ``capacity`` lanes
    (``idx`` = flattened lane*K+key, -1 for empty lanes).  Values are the
    absolute cumulative counts, so apply is a scatter-max."""

    idx: torch.Tensor            # i32[capacity]
    inc: torch.Tensor            # i32[capacity]
    dec: torch.Tensor            # i32[capacity]


# ---------------------------------------------------------------------------
# Bit packing (numpy's big-endian ``packbits`` / ``unpackbits``)
# ---------------------------------------------------------------------------

_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def packbits(bits: torch.Tensor) -> torch.Tensor:
    """bool[..., N] -> uint8[..., ceil(N/8)], first element in the high
    bit (``jnp.packbits`` along the last axis)."""
    n = bits.shape[-1]
    pad = -n % 8
    b = torch.nn.functional.pad(bits.to(torch.uint8), (0, pad))
    b = b.reshape(*bits.shape[:-1], -1, 8)
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=bits.device)
    return (b * w).sum(dim=-1, dtype=torch.uint8)


def unpackbits(packed: torch.Tensor, count: int) -> torch.Tensor:
    """uint8[..., M] -> bool[..., count] (``jnp.unpackbits(..., count=)``)."""
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] & w) != 0
    return bits.reshape(*packed.shape[:-1], -1)[..., :count]


# ---------------------------------------------------------------------------
# Row-run helpers (shared by GLog / RGA / SlotDoc)
# ---------------------------------------------------------------------------


def _expand(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (ndim - mask.dim()))


def _gather_runs(arr: torch.Tensor, start: torch.Tensor, num: torch.Tensor,
                 capacity: int) -> torch.Tensor:
    """arr [C, L, ...] -> [C, capacity, ...]: per-row slice from ``start``."""
    c, l = arr.shape[:2]
    j = torch.arange(capacity, dtype=torch.int32, device=arr.device)
    src = (start[:, None] + j[None, :]).clamp(0, l - 1).long()
    rows = torch.arange(c, device=arr.device)[:, None]
    vals = arr[rows, src]
    mask = j[None, :] < num[:, None]
    return torch.where(_expand(mask, arr.dim()), vals,
                       torch.zeros((), dtype=arr.dtype, device=arr.device))


def _scatter_runs(arr: torch.Tensor, start: torch.Tensor, num: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """Write [C, capacity, ...] runs back at ``start``; lanes past ``num``
    (and past the row) are dropped, never clipped onto live slots."""
    c, l = arr.shape[:2]
    capacity = vals.shape[1]
    j = torch.arange(capacity, dtype=torch.int32, device=arr.device)
    pos = start[:, None] + j[None, :]
    write = (j[None, :] < num[:, None]) & (pos < l) & (pos >= 0)
    rows = torch.arange(c, device=arr.device)[:, None].expand(c, capacity)
    out = arr.clone()
    out[rows[write], pos[write].long()] = vals[write].to(arr.dtype)
    return out


def _advance_watermark(current: torch.Tensor, start: torch.Tensor,
                       num: torch.Tensor) -> torch.Tensor:
    """Causal-delta-merging guard: only advance over contiguous runs."""
    return torch.where(start <= current, torch.maximum(current, start + num),
                       current)


# ---------------------------------------------------------------------------
# Per-type frontier / extract / apply
# ---------------------------------------------------------------------------

# -- GLog -------------------------------------------------------------------

def _glog_frontier(state: gset.GLog) -> LogFrontier:
    return LogFrontier(count=state.count)


def _glog_extract(state: gset.GLog, fr: LogFrontier, capacity: int
                  ) -> tuple[LogDelta, LogFrontier]:
    start = torch.minimum(fr.count, state.count)
    num = (state.count - start).clamp(0, capacity)
    fields = {name: _gather_runs(arr, start, num, capacity)
              for name, arr in state.fields.items()}
    return (LogDelta(start=start, num=num, fields=fields),
            LogFrontier(count=start + num))


def _glog_apply(state: gset.GLog, d: LogDelta) -> gset.GLog:
    fields = {name: _scatter_runs(arr, d.start, d.num, d.fields[name])
              for name, arr in state.fields.items()}
    return gset.GLog(count=_advance_watermark(state.count, d.start, d.num),
                     fields=fields)


# -- RGA --------------------------------------------------------------------

def _rga_frontier(state: rga.RGA) -> LogFrontier:
    return LogFrontier(count=state.count)


def _rga_extract(state: rga.RGA, fr: LogFrontier, capacity: int
                 ) -> tuple[RGADelta, LogFrontier]:
    start = torch.minimum(fr.count, state.count)
    num = (state.count - start).clamp(0, capacity)
    delta = RGADelta(
        start=start, num=num,
        op_clock=_gather_runs(state.op_clock, start, num, capacity),
        origin=_gather_runs(state.origin, start, num, capacity),
        token=_gather_runs(state.token, start, num, capacity),
        deleted_bits=packbits(state.deleted))
    return delta, LogFrontier(count=start + num)


def _rga_apply(state: rga.RGA, d: RGADelta) -> rga.RGA:
    deleted = state.deleted | unpackbits(d.deleted_bits, state.capacity)
    return rga.RGA(
        count=_advance_watermark(state.count, d.start, d.num),
        op_clock=_scatter_runs(state.op_clock, d.start, d.num, d.op_clock),
        origin=_scatter_runs(state.origin, d.start, d.num, d.origin),
        token=_scatter_runs(state.token, d.start, d.num, d.token),
        deleted=deleted)


# -- LWWBank ----------------------------------------------------------------

def _lww_frontier(bank: lww.LWWBank) -> KeyFrontier:
    return KeyFrontier(key=bank.key)


def _lww_extract(bank: lww.LWWBank, fr: KeyFrontier, capacity: int
                 ) -> tuple[LWWDelta, KeyFrontier]:
    k = bank.clock.shape[0]
    cap = min(capacity, k)
    key = bank.key
    changed = key > fr.key
    # Oldest (smallest-key) changed registers ship first, so a starved
    # register is eventually among the ``cap`` smallest.  The sort is
    # stable: unchanged registers tie at INT32_MAX.
    priority = torch.where(changed, key, INT32_MAX)
    order = torch.argsort(priority, stable=True)[:cap]
    take = changed[order]
    idx = torch.where(take, order.to(torch.int32), -1)
    zero = lambda v: torch.where(_expand(take, v.dim()), v,
                                 torch.zeros((), dtype=v.dtype,
                                             device=v.device))
    payload = {name: zero(arr[order]) for name, arr in bank.payload.items()}
    delta = LWWDelta(idx=idx,
                     clock=torch.where(take, bank.clock[order], 0),
                     client=torch.where(take, bank.client[order], 0),
                     payload=payload)
    shipped = torch.zeros((k,), dtype=torch.bool, device=key.device)
    shipped[order[take]] = True
    return delta, KeyFrontier(key=torch.where(shipped, key, fr.key))


def _lww_apply(bank: lww.LWWBank, d: LWWDelta) -> lww.LWWBank:
    k = bank.clock.shape[0]
    dkey = pack_key(d.clock, d.client)
    safe = d.idx.clamp(0, k - 1).long()
    wins = (d.idx >= 0) & (dkey > bank.key[safe])
    tgt = d.idx[wins].long()
    payload = {}
    for name, arr in bank.payload.items():
        out = arr.clone()
        out[tgt] = d.payload[name][wins].to(arr.dtype)
        payload[name] = out
    clock, client = bank.clock.clone(), bank.client.clone()
    clock[tgt] = d.clock[wins]
    client[tgt] = d.client[wins]
    return lww.LWWBank(clock=clock, client=client, payload=payload)


# -- SlotDoc ----------------------------------------------------------------

def _slot_frontier(doc: doc_mod.SlotDoc) -> SlotFrontier:
    return SlotFrontier(length=doc.length)


def _slot_extract(doc: doc_mod.SlotDoc, fr: SlotFrontier, capacity: int
                  ) -> tuple[SlotDelta, SlotFrontier]:
    start = torch.minimum(fr.length, doc.length)
    num = (doc.length - start).clamp(0, capacity)
    delta = SlotDelta(start=start, num=num,
                      tokens=_gather_runs(doc.tokens, start, num, capacity),
                      owner=doc.owner)
    return delta, SlotFrontier(length=start + num)


def _slot_apply(doc: doc_mod.SlotDoc, d: SlotDelta) -> doc_mod.SlotDoc:
    return doc_mod.SlotDoc(
        tokens=_scatter_runs(doc.tokens, d.start, d.num, d.tokens),
        length=_advance_watermark(doc.length, d.start, d.num),
        owner=torch.maximum(doc.owner, d.owner))


# -- GCounter / GSet --------------------------------------------------------

def _gcounter_frontier(state: gset.GCounter) -> torch.Tensor:
    return state.counts


def _gcounter_extract(state: gset.GCounter, fr: torch.Tensor, capacity: int
                      ) -> tuple[CounterDelta, torch.Tensor]:
    return CounterDelta(counts=state.counts), state.counts


def _gcounter_apply(state: gset.GCounter, d: CounterDelta) -> gset.GCounter:
    return gset.GCounter(torch.maximum(state.counts, d.counts))


def _gset_frontier(state: gset.GSet) -> torch.Tensor:
    return state.member


def _gset_extract(state: gset.GSet, fr: torch.Tensor, capacity: int
                  ) -> tuple[SetDelta, torch.Tensor]:
    return SetDelta(bits=packbits(state.member)), state.member


def _gset_apply(state: gset.GSet, d: SetDelta) -> gset.GSet:
    n = state.member.shape[0]
    return gset.GSet(state.member | unpackbits(d.bits, n))


# -- PNCounter --------------------------------------------------------------

def _pn_frontier(state: counter_mod.PNCounter) -> PNFrontier:
    return PNFrontier(inc=state.inc, dec=state.dec)


def _pn_extract(state: counter_mod.PNCounter, fr: PNFrontier, capacity: int
                ) -> tuple[PNDelta, PNFrontier]:
    r, k = state.inc.shape
    n = r * k
    cap = min(capacity, n)
    inc_f, dec_f = state.inc.reshape(-1), state.dec.reshape(-1)
    fr_inc, fr_dec = fr.inc.reshape(-1), fr.dec.reshape(-1)
    changed = (inc_f > fr_inc) | (dec_f > fr_dec)
    # Smallest-total changed cells ship first (as in _lww_extract).
    priority = torch.where(changed, inc_f + dec_f, INT32_MAX)
    order = torch.argsort(priority, stable=True)[:cap]
    take = changed[order]
    delta = PNDelta(idx=torch.where(take, order.to(torch.int32), -1),
                    inc=torch.where(take, inc_f[order], 0),
                    dec=torch.where(take, dec_f[order], 0))
    shipped = torch.zeros((n,), dtype=torch.bool, device=inc_f.device)
    shipped[order[take]] = True
    return delta, PNFrontier(
        inc=torch.where(shipped, inc_f, fr_inc).reshape(r, k),
        dec=torch.where(shipped, dec_f, fr_dec).reshape(r, k))


def _pn_apply(state: counter_mod.PNCounter, d: PNDelta
              ) -> counter_mod.PNCounter:
    r, k = state.inc.shape
    live = d.idx >= 0                        # empty lanes are dropped
    tgt = d.idx[live].long()
    out = []
    for cur, new in ((state.inc, d.inc), (state.dec, d.dec)):
        flat = cur.reshape(-1).clone()
        flat.scatter_reduce_(0, tgt, new[live], reduce="amax")
        out.append(flat.reshape(r, k))
    return counter_mod.PNCounter(inc=out[0], dec=out[1])


# -- TodoBoard --------------------------------------------------------------

def _board_frontier(board: todo.TodoBoard) -> KeyFrontier:
    return _lww_frontier(board.bank)


def _board_extract(board: todo.TodoBoard, fr: KeyFrontier, capacity: int
                   ) -> tuple[LWWDelta, KeyFrontier]:
    return _lww_extract(board.bank, fr, capacity)


def _board_apply(board: todo.TodoBoard, d: LWWDelta) -> todo.TodoBoard:
    return todo.TodoBoard(_lww_apply(board.bank, d))


# ---------------------------------------------------------------------------
# Registry + public dispatch
# ---------------------------------------------------------------------------

_FRONTIER = {
    gset.GLog: _glog_frontier,
    rga.RGA: _rga_frontier,
    lww.LWWBank: _lww_frontier,
    doc_mod.SlotDoc: _slot_frontier,
    gset.GCounter: _gcounter_frontier,
    gset.GSet: _gset_frontier,
    todo.TodoBoard: _board_frontier,
    counter_mod.PNCounter: _pn_frontier,
}

_EXTRACT = {
    gset.GLog: _glog_extract,
    rga.RGA: _rga_extract,
    lww.LWWBank: _lww_extract,
    doc_mod.SlotDoc: _slot_extract,
    gset.GCounter: _gcounter_extract,
    gset.GSet: _gset_extract,
    todo.TodoBoard: _board_extract,
    counter_mod.PNCounter: _pn_extract,
}

_APPLY = {
    gset.GLog: _glog_apply,
    rga.RGA: _rga_apply,
    lww.LWWBank: _lww_apply,
    doc_mod.SlotDoc: _slot_apply,
    gset.GCounter: _gcounter_apply,
    gset.GSet: _gset_apply,
    todo.TodoBoard: _board_apply,
    counter_mod.PNCounter: _pn_apply,
}


def is_delta_crdt(x: Any) -> bool:
    return type(x) in _FRONTIER


def frontier(state: Any) -> Any:
    """Watermark of everything ``state`` has observed (dicts recurse)."""
    fn = _FRONTIER.get(type(state))
    if fn is not None:
        return fn(state)
    if isinstance(state, dict):
        return {k: frontier(v) for k, v in state.items()}
    raise TypeError(f"no delta support for {type(state).__name__}")


def _cap_for(capacity: Any, key: str) -> Any:
    """A per-key delta capacity: a plain int, or a tuple of ``(key, cap)``
    pairs with a ``"*"`` default."""
    if isinstance(capacity, int):
        return capacity
    spec = dict(capacity)
    return spec.get(key, spec["*"])


def extract(state: Any, fr: Any, capacity: Any) -> tuple[Any, Any]:
    """Delta of ``state`` beyond ``fr`` plus the frontier actually shipped."""
    fn = _EXTRACT.get(type(state))
    if fn is not None:
        if not isinstance(capacity, int):
            capacity = _cap_for(capacity, "*")
        return fn(state, fr, capacity)
    if isinstance(state, dict):
        pairs = {k: extract(v, fr[k], _cap_for(capacity, k))
                 for k, v in state.items()}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    raise TypeError(f"no delta support for {type(state).__name__}")


def apply(state: Any, delta: Any) -> Any:
    """Join a delta into a replica (idempotent, order-insensitive)."""
    fn = _APPLY.get(type(state))
    if fn is not None:
        return fn(state, delta)
    if isinstance(state, dict):
        return {k: apply(v, delta[k]) for k, v in state.items()}
    raise TypeError(f"no delta support for {type(state).__name__}")


def join_frontiers(a: Any, b: Any) -> Any:
    """Frontiers are monotone watermarks: the join is elementwise max/OR."""
    return tree.map(lambda x, y: x | y if x.dtype == torch.bool
                    else torch.maximum(x, y), a, b)


# ---------------------------------------------------------------------------
# Host-side accounting + the gossip loop
# ---------------------------------------------------------------------------


def nbytes(state: Any) -> int:
    """Wire size of a tree: the fixed-capacity buffers ARE the payload."""
    return int(sum(x.numel() * x.element_size() for x in tree.leaves(state)))


def full_state_wire_bytes(strategy: str, n: int, state_bytes: int) -> int:
    """Wire bytes for one full-state sync of N replicas.

    allgather: every replica ships its full state to N-1 peers.  pmax: ring
    all-reduce, reduce-scatter + all-gather each move ~state_bytes across
    the ring.  The delta strategy is accounted exactly (``nbytes`` of the
    buffers actually shipped) rather than modelled."""
    if strategy == "allgather":
        return n * (n - 1) * state_bytes
    if strategy == "pmax":
        return 2 * (n - 1) * state_bytes
    raise ValueError(f"no full-state wire model for strategy: {strategy}")


class DeltaSync:
    """Host-side delta gossip among N replicas sharing a frontier.

    Every replica extracts its delta against the shared frontier, every
    delta is applied to every other replica, and the frontier advances to
    the join of what was shipped.  ``bytes_shipped`` accumulates the
    ring-model wire cost: each delta traverses N-1 links."""

    def __init__(self, template: Any, capacity: int = 64):
        self.capacity = capacity
        self.frontier = frontier(template)
        self.bytes_shipped = 0
        self.syncs = 0

    def sync(self, replicas: list[Any]) -> list[Any]:
        n = len(replicas)
        pairs = [extract(r, self.frontier, self.capacity) for r in replicas]
        deltas = [d for d, _ in pairs]
        self.bytes_shipped += sum(nbytes(d) for d in deltas) * (n - 1)
        self.syncs += 1
        outs = []
        for i, r in enumerate(replicas):
            for j, d in enumerate(deltas):
                if j != i:
                    r = apply(r, d)
            outs.append(r)
        self.frontier = functools.reduce(join_frontiers,
                                         [f for _, f in pairs])
        return outs
