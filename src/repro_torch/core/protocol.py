"""TODO-claim protocol: optimistic write-verify.

  1. scan   — ``todo.pick`` over the merged board (deterministic, rotated),
  2. claim  — LWW write with the agent's ticked Lamport clock,
  3. sync   — a merge of the replicas' boards (an exact join),
  4. verify — the claim succeeded iff the merged register names this agent.

Concurrent claims on key k resolve via the (clock, client) total order, and
every replica converges to the same winner.  ``merge_fn`` is injected: the
host-side orchestration passes a fold over replica states.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core import todo, tree
from repro_torch.core.clock import Lamport, i32

MergeFn = Callable[[todo.TodoBoard], todo.TodoBoard]


class ClaimOutcome(NamedTuple):
    board: todo.TodoBoard    # post-merge board
    lamport: Lamport         # advanced clock
    todo_id: torch.Tensor    # i32 — the key this agent attempted
    attempted: torch.Tensor  # bool — a ready TODO existed
    won: torch.Tensor        # bool — verify read names this agent


def _select(found: torch.Tensor, new, old):
    return tree.map(lambda n, o: torch.where(found, n, o), new, old)


def try_claim(board: todo.TodoBoard, lamport: Lamport, now,
              merge_fn: MergeFn) -> ClaimOutcome:
    """One scan→claim→sync→verify round for one agent."""
    lam = lamport.observe(board.max_clock())
    k, found = todo.pick(board, lam.client)
    proposed = _select(found, todo.claim(board, k, lam.client, lam.time, now),
                       board)
    merged = merge_fn(proposed)
    won = (found & (merged.status[k] == todo.CLAIMED)
           & (merged.assignee[k] == lam.client))
    return ClaimOutcome(board=merged, lamport=lam, todo_id=k,
                        attempted=found, won=won)


def complete(board: todo.TodoBoard, lamport: Lamport, k, merge_fn: MergeFn
             ) -> tuple[todo.TodoBoard, Lamport]:
    lam = lamport.observe(board.max_clock())
    return merge_fn(todo.complete(board, k, lam.client, lam.time)), lam


def reclaim_stale(board: todo.TodoBoard, lamport: Lamport, now, timeout,
                  merge_fn: MergeFn) -> tuple[todo.TodoBoard, Lamport]:
    """Liveness sweep (the paper's 120 s reclaim): any live agent may run
    it."""
    lam = lamport.observe(board.max_clock())
    return merge_fn(todo.reset_stale(board, now, timeout, lam.time,
                                     lam.client)), lam


def concurrent_claims(board: todo.TodoBoard, clients: torch.Tensor,
                      clocks: torch.Tensor, now
                      ) -> tuple[todo.TodoBoard, torch.Tensor, torch.Tensor]:
    """N agents propose claims against one observed board snapshot.

    Returns (merged_board, todo_ids i32[N], won bool[N]): a fold of the
    per-agent proposals through the join, in agent order (the JAX
    ``fori_loop`` becomes a loop over the N proposals)."""
    from repro_torch.core import merge as merge_mod
    n = clients.shape[0]
    dev = board.status.device
    acc = board
    ks, founds = [], []
    for i in range(n):
        k, found = todo.pick(board, clients[i])
        prop = _select(found, todo.claim(board, k, clients[i], clocks[i],
                                         now), board)
        acc = merge_mod.join(acc, prop)
        ks.append(k)
        founds.append(found)
    ks_t = (torch.stack(ks) if ks
            else torch.zeros((0,), dtype=torch.int32, device=dev))
    f_t = (torch.stack(founds) if founds
           else torch.zeros((0,), dtype=torch.bool, device=dev))
    kl = ks_t.long()
    won = (f_t & (acc.status[kl] == todo.CLAIMED)
           & (acc.assignee[kl] == i32(clients, dev)))
    return acc, ks_t, won
