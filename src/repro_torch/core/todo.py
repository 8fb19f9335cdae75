"""TodoBoard: the paper's Y.Map TODO coordination state.

A fixed bank of K TODO registers over an LWWBank.  Each register packs
{status, assignee, claim_time} and a dependency row.  All writes go through
LWW semantics, so concurrent claims resolve by lexicographic (clock,
client) order, identically on every replica (at most one winner).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import lww
from repro_torch.core.clock import i32

# Status enum (monotone in intent, enforced by protocol not by type).
EMPTY, PENDING, CLAIMED, DONE = 0, 1, 2, 3


class TodoBoard(NamedTuple):
    bank: lww.LWWBank     # payload: status, assignee, claim_time i32[K]; deps bool[K, K]

    @property
    def num_todos(self) -> int:
        return self.bank.clock.shape[0]

    @property
    def status(self) -> torch.Tensor:
        return self.bank.payload["status"]

    @property
    def assignee(self) -> torch.Tensor:
        return self.bank.payload["assignee"]

    @property
    def claim_time(self) -> torch.Tensor:
        return self.bank.payload["claim_time"]

    @property
    def deps(self) -> torch.Tensor:
        return self.bank.payload["deps"]

    def max_clock(self) -> torch.Tensor:
        return self.bank.clock.max()


def empty(num_todos: int, device=None) -> TodoBoard:
    spec = {"status": ((), torch.int32),
            "assignee": ((), torch.int32),
            "claim_time": ((), torch.int32),
            "deps": ((num_todos,), torch.bool)}
    return TodoBoard(bank=lww.empty(num_todos, spec, device=device))


def post(board: TodoBoard, k, deps_row, clock, client) -> TodoBoard:
    """Outliner publishes TODO k with its dependency row (bool[K])."""
    return TodoBoard(lww.write(board.bank, k, clock, client, status=PENDING,
                               assignee=0, claim_time=0, deps=deps_row))


def claim(board: TodoBoard, k, agent, clock, now) -> TodoBoard:
    return TodoBoard(lww.write(board.bank, k, clock, agent, status=CLAIMED,
                               assignee=agent, claim_time=now,
                               deps=board.deps[int(k)]))


def complete(board: TodoBoard, k, agent, clock) -> TodoBoard:
    return TodoBoard(lww.write(board.bank, k, clock, agent, status=DONE,
                               assignee=agent,
                               claim_time=board.claim_time[int(k)],
                               deps=board.deps[int(k)]))


def reset_stale(board: TodoBoard, now, timeout, clock, client) -> TodoBoard:
    """Liveness: claims whose holder went silent revert to PENDING."""
    dev = board.status.device
    stale = (board.status == CLAIMED) & (
        i32(now, dev) - board.claim_time > i32(timeout, dev))
    return TodoBoard(lww.write_masked(board.bank, stale, clock, client,
                                      status=PENDING, assignee=0,
                                      claim_time=0, deps=board.deps))


def done_mask(board: TodoBoard) -> torch.Tensor:
    return board.status == DONE


def ready_mask(board: TodoBoard) -> torch.Tensor:
    """PENDING and every dependency DONE."""
    done = done_mask(board)
    deps_ok = torch.all(~board.deps | done[None, :], dim=1)
    return (board.status == PENDING) & deps_ok


def pick(board: TodoBoard, agent) -> tuple[torch.Tensor, torch.Tensor]:
    """Deterministic next-TODO choice, rotated per agent to de-collide
    claims.  Returns (k, found); safety never depends on the rotation."""
    k_count = board.num_todos
    ready = ready_mask(board)
    idx = torch.arange(k_count, dtype=torch.int32, device=ready.device)
    rot = torch.remainder(idx - i32(agent, ready.device) * 3, k_count)
    score = torch.where(ready, k_count - rot, -1)
    k = torch.argmax(score)              # first maximum, as jnp.argmax
    return k.to(torch.int32), ready[k]


def all_done(board: TodoBoard) -> torch.Tensor:
    posted = board.status != EMPTY
    return torch.all(~posted | (board.status == DONE))
