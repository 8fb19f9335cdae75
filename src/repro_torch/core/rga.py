"""Array-backed RGA sequence CRDT — the Y.Text analogue.

State = per-client append-only op logs.  An op is identified by its slot
``oid = client * capacity + index``.  Each op carries its Lamport
``op_clock``, the ``origin`` oid it was inserted after (HEAD = C*L for the
document start), its ``token`` and a ``deleted`` tombstone (join = OR).

``materialize`` inserts ops in ascending (clock, client) order, each right
after its origin in a linked list, which reconstructs the RGA preorder.
The sort is a stable argsort on the card or CPU; the list build and walk
are inherently sequential and run as host loops over the op arrays (the
JAX package runs them as ``fori_loop``s), so the result is exact.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.clock import i32, pack_key

INT32_MAX = torch.iinfo(torch.int32).max


class RGA(NamedTuple):
    count: torch.Tensor      # i32[C]    valid ops in row c are [0, count[c])
    op_clock: torch.Tensor   # i32[C, L]
    origin: torch.Tensor     # i32[C, L] oid of left neighbour; HEAD = C*L
    token: torch.Tensor      # i32[C, L]
    deleted: torch.Tensor    # bool[C, L]

    @property
    def num_clients(self) -> int:
        return self.op_clock.shape[0]

    @property
    def capacity(self) -> int:
        return self.op_clock.shape[1]

    @property
    def head_oid(self) -> int:
        return self.num_clients * self.capacity

    def valid_mask(self) -> torch.Tensor:
        """bool[C, L]; replicas stacked on a leading axis pass through."""
        idx = torch.arange(self.op_clock.shape[-1], dtype=torch.int32,
                           device=self.count.device)
        return idx < self.count.unsqueeze(-1)

    def max_clock(self) -> torch.Tensor:
        """Largest observed Lamport time (for the Lamport receive rule)."""
        return torch.where(self.valid_mask(), self.op_clock, 0).max()


def empty(num_clients: int, capacity: int, device=None) -> RGA:
    dev = resolve_device(device)
    z = torch.zeros((num_clients, capacity), dtype=torch.int32, device=dev)
    return RGA(count=torch.zeros((num_clients,), dtype=torch.int32,
                                 device=dev),
               op_clock=z, origin=z.clone(), token=z.clone(),
               deleted=torch.zeros((num_clients, capacity), dtype=torch.bool,
                                   device=dev))


def insert(state: RGA, client, clock, origin_oid, token) -> RGA:
    """Append one insert-op to ``client``'s own row (dropped if full)."""
    c = int(client)
    pos = int(state.count[c])
    if pos >= state.capacity:
        return state
    dev = state.count.device
    out = {}
    for name, v in (("op_clock", clock), ("origin", origin_oid),
                    ("token", token)):
        arr = getattr(state, name).clone()
        arr[c, pos] = i32(v, dev)
        out[name] = arr
    count = state.count.clone()
    count[c] += 1
    return RGA(count=count, deleted=state.deleted, **out)


def insert_run(state: RGA, client, clock0, origin_oid, tokens: torch.Tensor,
               length) -> RGA:
    """Insert a contiguous run of ``length`` tokens after ``origin_oid``.

    Each token's origin is its predecessor in the run, so a run is a chain
    in the RGA tree and can never be interleaved by a concurrent run."""
    run_cap = tokens.shape[0]
    c = int(client)
    cap = state.capacity
    pos0 = int(state.count[c])
    room = min(max(cap - pos0, 0), run_cap)
    n = min(int(length), room)
    dev = state.count.device
    count = state.count.clone()
    count[c] += n
    if n <= 0:
        return state._replace(count=count)
    j = torch.arange(n, dtype=torch.int32, device=dev)
    origins = c * cap + (pos0 + j) - 1
    origins[0] = i32(origin_oid, dev)
    vals = {"op_clock": i32(clock0, dev) + j, "origin": origins,
            "token": i32(tokens[:n], dev)}
    out = {}
    for name, v in vals.items():
        arr = getattr(state, name).clone()
        arr[c, pos0:pos0 + n] = v
        out[name] = arr
    return RGA(count=count, deleted=state.deleted, **out)


def delete(state: RGA, oid) -> RGA:
    c, i = divmod(int(oid), state.capacity)
    if not -state.num_clients <= c < state.num_clients:
        return state                   # out of bounds: dropped, as in JAX
    deleted = state.deleted.clone()
    deleted[c, i] = True
    return state._replace(deleted=deleted)


def merge(a: RGA, b: RGA) -> RGA:
    """Join: per-slot union of observed ops; tombstones OR."""
    mine = a.valid_mask()
    return RGA(count=torch.maximum(a.count, b.count),
               op_clock=torch.where(mine, a.op_clock, b.op_clock),
               origin=torch.where(mine, a.origin, b.origin),
               token=torch.where(mine, a.token, b.token),
               deleted=a.deleted | b.deleted)


def materialize(state: RGA) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Deterministic document: (tokens i32[N], oids i32[N], visible_len).

    ``tokens``/``oids`` are left-packed over visible (non-tombstoned) ops;
    entries at index >= visible_len are -1."""
    C, L = state.op_clock.shape
    N = C * L
    dev = state.count.device
    valid_t = state.valid_mask().reshape(-1)
    client_f = torch.arange(C, dtype=torch.int32, device=dev).repeat_interleave(L)
    key = torch.where(valid_t, pack_key(state.op_clock.reshape(-1), client_f),
                      INT32_MAX)
    order = torch.argsort(key, stable=True).cpu().numpy()
    valid = valid_t.cpu().numpy()
    origin = state.origin.reshape(-1).cpu().numpy()
    token = state.token.reshape(-1).cpu().numpy()
    deleted = state.deleted.reshape(-1).cpu().numpy()

    nxt = [-1] * (N + 2)               # slot N = HEAD, N + 1 = scratch
    for x in order.tolist():
        if valid[x]:
            o = int(origin[x])
            nxt[x] = nxt[o]
            nxt[o] = x

    out_tok = np.full((N,), -1, np.int32)
    out_oid = np.full((N,), -1, np.int32)
    pos = 0
    cur = nxt[N]
    for _ in range(N):
        if cur < 0:
            break
        cur_c = min(max(cur, 0), N - 1)
        if not deleted[cur_c]:
            out_tok[pos] = token[cur_c]
            out_oid[pos] = cur_c
            pos += 1
        cur = nxt[cur_c]
    return (torch.from_numpy(out_tok).to(dev),
            torch.from_numpy(out_oid).to(dev),
            torch.tensor(pos, dtype=torch.int32, device=dev))
