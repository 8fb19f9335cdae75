"""End-to-end driver: parallel vs sequential multi-agent code generation
(the port's copy of the JAX package's ``examples/multi_agent_codegen.py``).

Runs the paper's experiment on one task with a real (tiny) decoder serving
stack: batched decode, CRDT claims, observation-driven invalidation,
convergence check — then prints the seq/par comparison and an evaluator
pass.

    PYTHONPATH=src python -m repro_torch.examples.multi_agent_codegen \\
        [task] [n_agents] [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.agents import evaluator
from repro_torch.agents.orchestrator import make_sim_llm, run_task
from repro_torch.agents.tasks import TASKS
from repro_torch.core import doc as doc_mod


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("task", nargs="?", default="dashboard")
    ap.add_argument("n_agents", type=int, nargs="?", default=4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg, params = make_sim_llm(device=args.device)
    dev = params["embed"]["w"].device
    task = TASKS[args.task]
    print(f"task={task.name} coupling={task.coupling} todos={task.n_todos} "
          f"volume_inflation={task.par_inflation}x")

    results = {}
    for mode in ("sequential", "parallel"):
        r = run_task(cfg, params, task, mode=mode, n_agents=args.n_agents,
                     seed=0, device=dev)
        results[mode] = r
        print(f"\n{mode:>10s}: steps={r.steps}  wall={r.wall_s:.2f}s  "
              f"tokens={r.gen_tokens}  replayed={r.replay_tokens}")
        print(f"{'':>10s}  invalidations={r.invalidations}  "
              f"claim_collisions={r.claim_collisions}  "
              f"semantic_conflicts={r.semantic_conflicts}")
        print(f"{'':>10s}  converged={r.converged}  digest={r.digest}")

    s, p = results["sequential"], results["parallel"]
    print(f"\nraw response (decode steps): {s.steps} -> {p.steps} "
          f"({100 * (p.steps - s.steps) / s.steps:+.1f}%)")
    print(f"normalized (steps / 1k tokens): {s.steps_per_1k_tokens:.0f} -> "
          f"{p.steps_per_1k_tokens:.0f} "
          f"({100 * (p.steps_per_1k_tokens - s.steps_per_1k_tokens) / s.steps_per_1k_tokens:+.1f}%)")
    print("(paper's finding: raw time can invert on coupled tasks while "
          "normalized time still favors parallel)")

    # Evaluator pass (paper §4.3): detect semantic conflicts the CRDT cannot
    # see, auto-reconcile duplicates with rename patches (themselves CRDT
    # edits), on a document with a conflict built for the demo.
    i32 = lambda xs: torch.tensor(xs, dtype=torch.int32, device=dev)
    demo = doc_mod.empty(4, 32, device=dev)
    demo = doc_mod.append(demo, 0, i32([5, 7, 0, 0]), 2)   # declares sym 5
    demo = doc_mod.append(demo, 1, i32([5, 9, 0, 0]), 2)   # duplicate!
    fixed, report = evaluator.reconcile(demo)
    print(f"\nevaluator: {len(report.conflicts)} conflict(s), "
          f"{report.fixed} auto-fixed, {len(report.flagged)} flagged")
    print(f"scores: {evaluator.score(fixed)}")


if __name__ == "__main__":
    main()
