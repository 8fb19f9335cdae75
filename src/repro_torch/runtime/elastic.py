"""Elastic, fault-tolerant work distribution via the CRDT TodoBoard.

The paper's TODO-claim protocol, reused as the training control plane:
*data shards* are the TODOs.  Workers claim shards through the optimistic
write-verify protocol (at-most-one-winner ⇒ no duplicated work in the steady
state), heartbeat through a G-counter, and any live worker can reclaim
shards whose owner went silent (the paper's 120 s liveness rule).  Because
shard → batches is a pure function (``data/pipeline.py``), a reclaimed shard
reproduces identical data, so worker loss never skews the data distribution
— duplicated work on the loss boundary is idempotent by construction.

Workers may join or leave between claims (elastic scaling); no central
scheduler exists — the merged CRDT state IS the schedule.  The queue is
host state: its CRDTs live on the CPU whatever device the trainer uses.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.core import gset, merge as merge_mod, protocol, todo
from repro_torch.core.clock import Lamport, i32

HOST = "cpu"


@dataclass
class WorkQueueState:
    board: todo.TodoBoard
    heartbeats: gset.GCounter          # monotone wall-clock per worker
    completed: gset.GSet               # shard done flags (redundant w/ board,
                                       # kept as the idempotent commit record)

    def merge(self, other: "WorkQueueState") -> "WorkQueueState":
        return WorkQueueState(
            board=merge_mod.join(self.board, other.board),
            heartbeats=self.heartbeats.join(other.heartbeats),
            completed=self.completed.join(other.completed),
        )


def make_queue(num_shards: int, num_workers: int) -> WorkQueueState:
    board = todo.empty(num_shards, device=HOST)
    lam = Lamport.create(client=1023, device=HOST)
    deps = torch.zeros((num_shards,), dtype=torch.bool)
    for k in range(num_shards):
        lam = lam.tick()
        board = todo.post(board, k, deps, lam.time, lam.client)
    return WorkQueueState(
        board=board,
        heartbeats=gset.GCounter.zeros(max(num_workers + 1, 8), device=HOST),
        completed=gset.GSet.empty(num_shards, device=HOST),
    )


class Worker:
    """One elastic worker's view of the queue.

    ``sync_fn`` plays the relay role: it takes this worker's state and
    returns the merged global state (in-process tests pass a shared fold;
    a real deployment merges through collectives or a gossip mesh —
    the protocol is substrate-agnostic, paper §3.2).
    """

    def __init__(self, worker_id: int, state: WorkQueueState,
                 sync_fn: Callable[[WorkQueueState], WorkQueueState],
                 *, stale_timeout: int = 120):
        if worker_id < 1:
            raise ValueError(f"worker ids start at 1, got {worker_id}")
        self.id = worker_id
        self.state = state
        self.sync = sync_fn
        self.lamport = Lamport.create(worker_id, device=HOST)
        self.stale_timeout = stale_timeout

    def _merge_board(self, board: todo.TodoBoard) -> todo.TodoBoard:
        self.state = self.sync(WorkQueueState(board, self.state.heartbeats,
                                              self.state.completed))
        return self.state.board

    def heartbeat(self, now: int) -> None:
        self.state.heartbeats = self.state.heartbeats.bump_to(self.id, now)
        self.state = self.sync(self.state)

    def try_claim_shard(self, now: int) -> Optional[int]:
        """Claim protocol round; returns the shard id on success."""
        out = protocol.try_claim(self.state.board, self.lamport,
                                 i32(now, HOST), self._merge_board)
        self.lamport = out.lamport
        self.state.board = out.board
        if bool(out.won):
            return int(out.todo_id)
        return None

    def complete_shard(self, shard_id: int) -> None:
        self.state.completed = self.state.completed.add(shard_id)
        board, self.lamport = protocol.complete(
            self.state.board, self.lamport, i32(shard_id, HOST),
            self._merge_board)
        self.state.board = board

    def reclaim_stale(self, now: int) -> int:
        """Reset claims past the timeout (paper's 120 s liveness rule);
        returns how many were reset."""
        before = int((self.state.board.status == todo.CLAIMED).sum())
        board, self.lamport = protocol.reclaim_stale(
            self.state.board, self.lamport, i32(now, HOST),
            i32(self.stale_timeout, HOST), self._merge_board)
        self.state.board = board
        after = int((board.status == todo.CLAIMED).sum())
        return before - after

    def stragglers(self, now: int, lag: int) -> list[int]:
        """Workers whose heartbeat lags ``now`` by more than ``lag``."""
        hb = self.state.heartbeats.counts.tolist()
        return [i for i in range(1, len(hb))
                if hb[i] > 0 and now - hb[i] > lag]

    def done(self) -> bool:
        return bool(todo.all_done(self.state.board))


def make_shared_fold_sync(shared: dict) -> Callable:
    """In-process 'relay': fold every worker's state into a shared cell."""
    def sync(state: WorkQueueState) -> WorkQueueState:
        shared["state"] = (state if "state" not in shared
                           else shared["state"].merge(state))
        return shared["state"]
    return sync
