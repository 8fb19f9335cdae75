"""Benchmark entry: one function per paper table, the serving sweep and
the roofline summary (the port's copy of the JAX package's
``benchmarks/run.py``).

Prints ``name,us_per_call,derived`` CSV rows (the harness contract).

  PYTHONHASHSEED=0 PYTHONPATH=src python -m repro_torch.benchmarks.run \\
      [--runs N] [--agents N] [--quick] [--force] [--device cpu]

The trials and the serving sweep run on the card unless ``--device cpu``.
The serving sweep also writes ``BENCH_serving_torch.json``.  The roofline
summary reads the dry run's single-mesh records (``launch/dryrun.py``:
``meta`` tensors, no card).  A missing record of a decode cell (one step,
seconds) or of a cell the arch does not apply to is made first; any other
missing cell gets a ``roofline/<arch>/<shape>/no_record`` row naming the
command that makes it (a train or prefill cell takes minutes on the CPU,
a recurrent model's up to hours: its plain scans run a step at a time).
"""
from __future__ import annotations

import argparse


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

    # Serving sweep: dense-vs-paged KV cache and the rest (also writes
    # BENCH_serving_torch.json).
    from repro_torch.benchmarks.bench_serving import run_bench
    run_bench(quick=args.quick, device=args.device)

    for row in roofline_rows():
        print(row)


def roofline_rows() -> list[str]:
    """The roofline summary over the dry run's single-mesh records, with
    the cheap missing ones made first and a row for each other missing
    one."""
    from repro_torch.benchmarks import roofline
    from repro_torch.configs import ARCHS
    from repro_torch.configs.shapes import SHAPES, applicable
    from repro_torch.launch import dryrun
    missing = []
    for arch in sorted(ARCHS):
        for shape in SHAPES.values():
            path = (dryrun.OUT_DIR / "single"
                    / f"{arch}__{shape.name}__baseline.json")
            if path.exists():
                continue
            if shape.kind == "decode" or not applicable(
                    dryrun.cell_config(arch), shape)[0]:
                dryrun.run_cell(arch, shape.name, "single")
            else:
                missing.append(
                    f"roofline/{arch}/{shape.name}/no_record,0,make it with "
                    f"python -m repro_torch.launch.dryrun --arch {arch} "
                    f"--shape {shape.name}")
    return roofline.summary_rows() + missing


if __name__ == "__main__":
    main()
