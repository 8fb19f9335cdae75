"""Quickstart: the CodeCRDT pattern in 60 lines (the port's copy of the
JAX package's ``examples/quickstart.py``).

Two simulated LLM agents implement a 4-TODO task concurrently, coordinating
only through CRDT state: optimistic claims with LWW arbitration, append-only
document slots, deterministic convergence.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core import doc, merge, protocol, todo
from repro_torch.core.clock import Lamport

K = 4


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args().device)
    i32 = lambda xs: torch.tensor(xs, dtype=torch.int32, device=dev)

    # 1. Outliner posts the TODO skeleton.
    board = todo.empty(K, device=dev)
    lam_out = Lamport.create(client=99, device=dev)
    for k in range(K):
        lam_out = lam_out.tick()
        board = todo.post(board, k, torch.zeros((K,), dtype=torch.bool,
                                                device=dev),
                          lam_out.time, lam_out.client)
    print("posted:", board.status.tolist())

    # 2. Two agents claim concurrently against the same snapshot; the CRDT
    #    merge arbitrates deterministically (at-most-one winner per TODO).
    clients = i32([1, 2])
    clocks = i32([10, 10])                          # adversarial tie!
    board, picks, won = protocol.concurrent_claims(board, clients, clocks,
                                                   i32(0))
    print("picks:", picks.tolist(), "won:", won.tolist(),
          "assignees:", board.assignee.tolist())

    # 3. Each winner writes code into its own *replica* of the document.
    replica_1 = doc.empty(K, 32, device=dev)
    replica_2 = doc.empty(K, 32, device=dev)
    replica_1 = doc.append(replica_1, int(picks[0]),
                           i32([104, 105, 0, 0]), 2)      # agent 1: "hi"
    replica_2 = doc.append(replica_2, int(picks[1]),
                           i32([33, 0, 0, 0]), 1)         # agent 2: "!"

    # 4. Replicas converge through the join — in ANY order.
    m12 = merge.join(replica_1, replica_2)
    m21 = merge.join(replica_2, replica_1)
    assert int(doc.digest(m12)) == int(doc.digest(m21))
    flat, n = doc.render(m12)
    print("converged document tokens:", flat[: int(n)].tolist())
    print("digests equal:", int(doc.digest(m12)) == int(doc.digest(m21)))


if __name__ == "__main__":
    main()
