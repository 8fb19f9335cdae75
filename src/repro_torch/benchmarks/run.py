"""Benchmark entry: one function per paper table (the port's copy of the
table part of the JAX package's ``benchmarks/run.py``).

Prints ``name,us_per_call,derived`` CSV rows (the harness contract).

  PYTHONHASHSEED=0 PYTHONPATH=src python -m repro_torch.benchmarks.run \\
      [--runs N] [--agents N] [--quick] [--force] [--device cpu]

The trials run on the card unless ``--device cpu``.  The serving sweep and
the roofline summary of the JAX entry are not ported: each prints one
``skipped`` row.
"""
from __future__ import annotations

import argparse

NOT_PORTED = "not ported (ROADMAP queue 1 item 15b)"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--quick", action="store_true",
                    help="2 runs/mode, smaller table6 sweep")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    runs = 2 if args.quick else args.runs

    from repro_torch.benchmarks import tables
    from repro_torch.benchmarks.common import run_suite, sim_llm

    sim_llm(args.device)
    print("name,us_per_call,derived")
    suite = run_suite(runs_per_mode=runs, n_agents=args.agents,
                      force=args.force)
    for row in tables.table3(suite):
        print(row)
    for row in tables.table4(suite):
        print(row)
    for row in tables.table5(suite):
        print(row)
    for row in tables.table6(runs=1 if args.quick else 2,
                             agents=(1, 2, 4) if args.quick
                             else (1, 2, 4, 8)):
        print(row)
    for row in tables.table7(suite):
        print(row)
    for row in tables.rq3_consistency(suite):
        print(row)
    for name in ("bench_serving", "roofline"):
        print(f"{name}/skipped,0,{NOT_PORTED}")


if __name__ == "__main__":
    main()
