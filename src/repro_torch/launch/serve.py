"""Serving launcher: batched multi-agent generation service.

Runs the CodeCRDT serving stack for an arch on the card (``--device cpu``
for the CPU): N agent streams on one decode batch, CRDT coordination, a
convergence report.  The model is the arch reduced to ``--d-model`` with
seeded random weights.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
      --task dashboard --mode parallel --agents 4 [--json] [--device cpu]
"""
from __future__ import annotations

import argparse
import json

import repro_torch.configs as configs
from repro_torch.agents.orchestrator import run_task
from repro_torch.agents.tasks import TASKS
from repro_torch.models import lm


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=sorted(configs.ARCHS))
    ap.add_argument("--task", default="dashboard", choices=sorted(TASKS))
    ap.add_argument("--mode", default="parallel",
                    choices=["sequential", "parallel", "both"])
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=64,
                    help="reduced model width")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = configs.reduced(configs.get(args.arch), d_model=args.d_model,
                          vocab=512)
    params = lm.init(cfg, seed=args.seed, device=args.device)

    modes = (["sequential", "parallel"] if args.mode == "both"
             else [args.mode])
    out = {}
    for mode in modes:
        r = run_task(cfg, params, TASKS[args.task], mode=mode,
                     n_agents=args.agents, seed=args.seed,
                     device=args.device)
        out[mode] = {
            "steps": r.steps, "wall_s": round(r.wall_s, 3),
            "tokens": r.gen_tokens, "invalidations": r.invalidations,
            "claim_collisions": r.claim_collisions,
            "semantic_conflicts": r.semantic_conflicts,
            "converged": r.converged,
        }
        if not args.json:
            print(f"[{cfg.name} × {args.task} × {mode}] "
                  f"steps={r.steps} wall={r.wall_s:.2f}s "
                  f"tokens={r.gen_tokens} conflicts={r.semantic_conflicts} "
                  f"converged={r.converged}")
    if args.json:
        print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
