"""Generate the data-driven tables of the experiments report from the
port's artifacts (the port's copy of the JAX package's
``benchmarks/expreport.py``).

    PYTHONPATH=src python -m repro_torch.benchmarks.expreport \\
        > experiments/report_torch.md

Pulls ``experiments/dryrun_torch/<mesh>/*.json`` (``launch/dryrun.py``:
baseline and variants) and ``experiments/bench_torch/suite_*.json`` (the
agent suite ``benchmarks/common.py`` caches).  The port's dry run compiles
nothing, so where JAX's tables show compile seconds and XLA's CPU temp
bytes these show the count's seconds and the aten ops counted; the
collective schedule shows the bytes the sharded step's collectives move
(a record without them, written before they were counted, says so instead
of printing zeros).
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.benchmarks.roofline import (CARD, DRYRUN_DIR, POWER_LIMIT,
                                             roofline)

GiB = 2 ** 30
SUITE_DIR = (Path(__file__).resolve().parents[3] / "experiments"
             / "bench_torch")


def _cells(mesh: str, variant: str = "baseline"):
    d = DRYRUN_DIR / mesh
    return [json.loads(f.read_text())
            for f in sorted(d.glob(f"*__{variant}.json"))]


def _coll(c: dict) -> str:
    coll = c.get("collective_bytes_per_device")
    return "not counted" if coll is None else f"{coll.get('total', 0):.3e}"


def dryrun_section() -> list[str]:
    out = ["### Dry-run results (both meshes, meta tensors)", ""]
    for mesh, chips in (("single", 256), ("multi", 512)):
        cells = _cells(mesh)
        ok = sum(1 for c in cells if c["status"] == "ok")
        sk = sum(1 for c in cells if c["status"] == "skipped")
        out.append(f"**{mesh}-pod ({chips} devices, stand-in)**: {ok} "
                   f"counted OK, {sk} documented skips, "
                   f"{len(cells) - ok - sk} errors.")
        out.append("")
        out.append("| arch | shape | status | count s | aten ops | "
                   "params/dev | state/dev |")
        out.append("|---|---|---|---|---|---|---|")
        for c in cells:
            if c["status"] == "skipped":
                out.append(f"| {c['arch']} | {c['shape']} | SKIP: "
                           f"{c['reason'][:48]} | | | | |")
                continue
            if c["status"] != "ok":
                out.append(f"| {c['arch']} | {c['shape']} | ERROR | | | | |")
                continue
            ma = c.get("memory_analytic", {})
            state = (ma.get("opt_per_device", 0)
                     + ma.get("cache_per_device", 0))
            out.append(
                f"| {c['arch']} | {c['shape']} | ok | {c['count_s']:.0f} "
                f"| {c['aten_ops']} "
                f"| {ma.get('params_per_device', 0)/GiB:.2f} GiB "
                f"| {state/GiB:.2f} GiB |")
        out.append("")
    out.append("*params/dev and state/dev: the partitioner's specs on the "
               "production mesh's stand-in (persistent state; the "
               "transient peak of a step needs a real run).*")
    out.append("")
    return out


def roofline_section(mesh: str = "single") -> list[str]:
    out = [f"### Roofline table ({mesh}-pod, baseline; peaks of the "
           f"{CARD}, {POWER_LIMIT})", "",
           "| arch | shape | t_compute (s) | t_memory (s) | t_collective (s)"
           " | dominant | MODEL/counted | roofline frac |",
           "|---|---|---|---|---|---|---|---|"]
    for c in _cells(mesh):
        if c["status"] == "skipped":
            out.append(f"| {c['arch']} | {c['shape']} | — | — | — | N/A | — "
                       f"| — |")
            continue
        r = roofline(c)
        if r is None:
            continue
        tc = ("not counted" if r["t_collective"] is None
              else f"{r['t_collective']:.3e}")
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute']:.3e} "
            f"| {r['t_memory']:.3e} | {tc} "
            f"| {r['dominant']} | {r['useful_ratio']:.3f} "
            f"| {r['roofline_fraction']:.3f} |")
    out.append("")
    return out


def variant_rows(arch: str, shape: str, variants: list[str],
                 mesh: str = "single") -> list[str]:
    out = ["| variant | flops/dev | bytes/dev | coll bytes/dev | t_dominant |",
           "|---|---|---|---|---|"]
    for v in ["baseline"] + variants:
        f = DRYRUN_DIR / mesh / f"{arch}__{shape}__{v}.json"
        if not f.exists():
            out.append(f"| {v} | (missing) | | | |")
            continue
        c = json.loads(f.read_text())
        if c["status"] != "ok":
            out.append(f"| {v} | ERROR | | | |")
            continue
        r = roofline(c)
        dom = r["dominant"]
        out.append(
            f"| {v} | {c['flops_per_device']:.3e} "
            f"| {c['bytes_per_device']:.3e} | {_coll(c)} "
            f"| {dom} {r['t_' + dom]:.3e}s |")
    return out


def agents_section() -> list[str]:
    caches = sorted(SUITE_DIR.glob("suite_*.json"))
    if not caches:
        return ["(run `python -m repro_torch.benchmarks.run` first)"]
    raw = json.loads(caches[-1].read_text())
    out = [f"### Agent suite (seq vs par; response time in decode steps; "
           f"{caches[-1].name})", "",
           "| task | coupling? | seq steps | par steps | Δ raw | seq tok "
           "| par tok | Δ vol | steps/1k seq | steps/1k par | inval(par) "
           "| conflicts(par) | converged |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    from repro_torch.agents.tasks import TASKS
    for t, modes in raw.items():
        sq = modes["sequential"]
        pr = modes["parallel"]
        m = lambda rs, k: sum(r[k] for r in rs) / len(rs)
        s_steps, p_steps = m(sq, "steps"), m(pr, "steps")
        s_tok, p_tok = m(sq, "gen_tokens"), m(pr, "gen_tokens")
        conv = all(r["converged"] for r in sq + pr)
        out.append(
            f"| {t} | {TASKS[t].coupling} | {s_steps:.0f} | {p_steps:.0f} "
            f"| {100*(p_steps-s_steps)/s_steps:+.1f}% "
            f"| {s_tok:.0f} | {p_tok:.0f} "
            f"| {100*(p_tok-s_tok)/s_tok:+.1f}% "
            f"| {1000*s_steps/s_tok:.0f} | {1000*p_steps/p_tok:.0f} "
            f"| {m(pr, 'invalidations'):.1f} "
            f"| {m(pr, 'semantic_conflicts'):.1f} | {conv} |")
    out.append("")
    return out


def schedule_section() -> list[str]:
    """Collective schedule of representative cells: bytes a device moves
    in a step, by op kind (JAX's ring model)."""
    out = ["### Collective schedule (bytes/device/step, representative cells)",
           "", "| cell | collective bytes |", "|---|---|"]
    picks = [("command-r-plus-104b", "train_4k"),
             ("deepseek-moe-16b", "train_4k"),
             ("command-r-plus-104b", "decode_32k"),
             ("olmo-1b", "decode_32k"),
             ("recurrentgemma-2b", "long_500k")]
    for arch, shape in picks:
        f = DRYRUN_DIR / "single" / f"{arch}__{shape}__baseline.json"
        if not f.exists():
            continue
        c = json.loads(f.read_text())
        if c["status"] != "ok":
            continue
        out.append(f"| {arch} × {shape} | {_coll(c)} |")
    out.append("")
    return out


def perf_variants_section() -> list[str]:
    out = ["### §Perf variant tables (raw numbers)", ""]
    cells = [
        ("deepseek-moe-16b", "train_4k",
         ["dense_dispatch", "no_remat", "cap_1.0", "cap1_noremat"]),
        ("deepseek-v2-lite-16b", "decode_32k", ["mla_repl", "mla_seq"]),
        ("olmo-1b", "decode_32k",
         ["fused_allgather", "fused_pmax", "fused_pmax_every4"]),
        ("xlstm-125m", "train_4k", ["serial_tscan"]),
        ("recurrentgemma-2b", "long_500k", ["ring_cache"]),
        ("recurrentgemma-2b", "decode_32k", ["ring_cache"]),
    ]
    for arch, shape, variants in cells:
        out.append(f"**{arch} × {shape}**")
        out.extend(variant_rows(arch, shape, variants))
        out.append("")
    return out


def main():
    print("\n".join(dryrun_section()))
    print("\n".join(schedule_section()))
    print("\n".join(roofline_section("single")))
    print("\n".join(perf_variants_section()))
    print("\n".join(agents_section()))


if __name__ == "__main__":
    main()
