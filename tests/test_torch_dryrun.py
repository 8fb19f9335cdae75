"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's ``launch/dryrun.py``, on the CPU.

JAX runs in one subprocess with 512 host devices (its dry run's own
``--xla_force_host_platform_device_count``: JAX only builds shardings
there, nothing compiles but two reduced cells), overlapped with the
port's side.  Held:

* ``memory_analytic`` bitwise equal to JAX's ``analytic_memory`` for every
  applicable (arch, shape) of ``configs.shapes`` on both production
  meshes, (16, 16) and (2, 16, 16), and ``model_flops_est`` equal; a
  skipped cell carries JAX's reason.  No cell differs: the known
  layer-axis difference of the ZeRO-1 specs (``test_torch_sharding.py``)
  does not reach this count, whose moments are sharded as the parameters
  are in both packages (JAX shards no stacked layer axis there).
* ``flops_per_device`` within a measured band of JAX's
  ``extrapolated_costs`` FLOPs on a reduced OLMo-1B (4 layers) train cell
  (64 tokens × 8) and decode cell (8 rows over 128 positions) on a 2 × 2
  host mesh.  FlopCounterMode counts the products (matmuls, attention);
  XLA's cost analysis also counts elementwise work (norms, softmax, RoPE,
  the optimizer), which at these narrow widths is most of a decode step:
  measured 0.872 of JAX's (train) and 0.311 (decode).
* The records: status, the null collective bytes naming ROADMAP item 24,
  incremental writes and ``--force``, a step counted once a process for
  both meshes and keyed on the cell's config, the CLI's flags (JAX's, and a flag
  that cannot apply raises), ``lm.abstract_params`` (``init``'s tree on
  ``meta`` tensors), the no-op ``lm.unrolled_scans``, and
  ``benchmarks.run``'s roofline rows where no record exists yet.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.sharding.mesh import StackedMesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = ("single", "multi")
CELLS = [f"{a}|{s}|{m}" for m in MESHES for a in sorted(tconfigs.ARCHS)
         for s in SHAPES]
APPLICABLE = [c for c in CELLS if applicable(
    tconfigs.get(c.split("|")[0]), SHAPES[c.split("|")[1]])[0]]
# The reduced cells of the FLOP band: (shape, band of port / JAX).
BAND_CELLS = {"train": (ShapeSpec("t", 64, 8, "train"), (0.75, 1.0)),
              "decode": (ShapeSpec("d", 128, 8, "decode"), (0.25, 0.45))}

JAX_SCRIPT = """
import json
from repro.launch import dryrun as jd  # 512 host devices, before jax
import jax
import numpy as np
from jax.sharding import Mesh
import repro.configs as configs
from repro.configs.shapes import SHAPES, ShapeSpec, applicable
from repro.launch import mesh as mesh_mod
out = {"memory": {}, "flops": {}}
for mk in ("single", "multi"):
    mesh = mesh_mod.make_production_mesh(multi_pod=(mk == "multi"))
    for arch in sorted(configs.ARCHS):
        cfg = configs.get(arch)
        for sh, shape in SHAPES.items():
            ok, reason = applicable(cfg, shape)
            out["memory"][f"{arch}|{sh}|{mk}"] = (
                [jd.analytic_memory(cfg, shape, mesh),
                 jd._model_flops(cfg, shape)] if ok else reason)
m4 = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
cfg = configs.reduced(configs.get("olmo-1b"), layers=4)
for name, (seq, batch, kind) in %r.items():
    out["flops"][name] = jd.extrapolated_costs(
        cfg, ShapeSpec(name, seq, batch, kind), m4)["flops"]
print(json.dumps(out))
"""


def _port_flops(name: str) -> float:
    shape = BAND_CELLS[name][0]
    cfg = tconfigs.reduced(tconfigs.get("olmo-1b"), layers=4)
    mesh = StackedMesh((2, 2), ("data", "model"))
    return dryrun.count_cell(cfg, shape, mesh)["flops"] / 4


@pytest.fixture(scope="module")
def both():
    """(JAX's results, the port's), the port's computed while JAX runs."""
    cells = {k: (s.seq_len, s.global_batch, s.kind)
             for k, (s, _) in BAND_CELLS.items()}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT % (cells,)],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        port = {"memory": {}, "flops": {}}
        for cell in APPLICABLE:
            arch, sh, mk = cell.split("|")
            cfg, shape = tconfigs.get(arch), SHAPES[sh]
            port["memory"][cell] = [
                dryrun.analytic_memory(cfg, shape,
                                       dryrun.production_mesh(mk)),
                dryrun._model_flops(cfg, shape)]
        for name in BAND_CELLS:
            port["flops"][name] = _port_flops(name)
        out, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.splitlines()[-1]), port


@pytest.mark.parametrize("cell", CELLS)
def test_memory_analytic_matches_jax(both, cell, tmp_path):
    jax_side, port = both
    want = jax_side["memory"][cell]
    if cell not in APPLICABLE:
        arch, sh, mk = cell.split("|")
        rec = dryrun.run_cell(arch, sh, mk, out_dir=tmp_path)
        assert rec["status"] == "skipped" and rec["reason"] == want
        return
    assert port["memory"][cell][0] == want[0]
    assert set(want[0]) >= {"params_per_device", "total_per_device"}


@pytest.mark.parametrize("cell", APPLICABLE)
def test_model_flops_matches_jax(both, cell):
    jax_side, port = both
    assert port["memory"][cell][1] == jax_side["memory"][cell][1]


@pytest.mark.parametrize("name", sorted(BAND_CELLS))
def test_flops_within_band_of_jax(both, name):
    jax_side, port = both
    lo, hi = BAND_CELLS[name][1]
    ratio = port["flops"][name] / jax_side["flops"][name]
    assert lo <= ratio <= hi, ratio


def test_records(tmp_path):
    kw = dict(out_dir=tmp_path)
    rec = dryrun.run_cell("olmo-1b", "decode_32k", "multi", **kw)
    assert rec["status"] == "ok" and rec["n_devices"] == 512
    assert rec["collective_bytes_per_device"] is None
    assert "item 24" in rec["collective_method"]
    assert "unfused eager" in rec["cost_method"]
    assert rec["memory_analytic"] == dryrun.analytic_memory(
        tconfigs.get("olmo-1b"), SHAPES["decode_32k"],
        dryrun.production_mesh("multi"))
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    path = tmp_path / "multi" / "olmo-1b__decode_32k__baseline.json"
    assert json.loads(path.read_text()) == rec
    # Incremental: a written cell is read back, not counted again.
    path.write_text(json.dumps(dict(rec, marker=1)))
    assert dryrun.run_cell("olmo-1b", "decode_32k", "multi",
                           **kw)["marker"] == 1
    assert "marker" not in dryrun.run_cell("olmo-1b", "decode_32k", "multi",
                                           force=True, **kw)
    # One process counts the step once for both meshes.
    counts: dict = {}
    multi = dryrun.run_cell("olmo-1b", "decode_32k", "multi", force=True,
                            counts=counts, **kw)
    single = dryrun.run_cell("olmo-1b", "decode_32k", "single",
                             counts=counts, **kw)
    assert len(counts) == 1
    assert single["flops_per_device"] == 2 * multi["flops_per_device"]
    # The fused step counts the coordination on top of the decode.
    fused = dryrun.run_cell("olmo-1b", "decode_32k", "single",
                            variant="fused_delta", fused_coord=True,
                            merge_strategy="delta", counts=counts, **kw)
    assert len(counts) == 2
    assert fused["bytes_per_device"] > single["bytes_per_device"]
    assert fused["options"]["merge_strategy"] == "delta"


def test_counts_are_keyed_on_the_cell_config(tmp_path, monkeypatch):
    """A step's counts are reused only for the same config, shape and
    options: another MoE dispatch counts anew, and so does every process
    (no record on disk lends its counts, ``--force`` or not)."""
    calls = []

    def fake(cfg, shape, mesh, **options):
        calls.append(cfg.moe.dispatch)
        return {"flops": 512.0 * len(calls), "bytes": 512.0, "ops": 1}

    monkeypatch.setattr(dryrun, "count_cell", fake)
    arch = "deepseek-v2-lite-16b"
    dispatch = tconfigs.get(arch).moe.dispatch
    other = next(d for d in ("gather", "dense") if d != dispatch)
    counts: dict = {}
    first = dryrun.run_cell(arch, "decode_32k", "single", counts=counts,
                            out_dir=tmp_path)
    dryrun.run_cell(arch, "decode_32k", "multi", counts=counts,
                    out_dir=tmp_path)
    assert calls == [dispatch]
    moved = dryrun.run_cell(arch, "decode_32k", "multi", variant=other,
                            moe_dispatch=other, counts=counts,
                            out_dir=tmp_path)
    assert calls == [dispatch, other]
    assert moved["flops_per_device"] != first["flops_per_device"] / 2
    # A new process (no ``counts``) counts again, beside the other mesh's
    # record of the same cell, and so does ``--force``.
    dryrun.run_cell(arch, "decode_32k", "multi", variant="again",
                    out_dir=tmp_path)
    dryrun.run_cell(arch, "decode_32k", "single", force=True,
                    out_dir=tmp_path)
    assert calls == [dispatch, other, dispatch, dispatch]


def test_cli_flags_are_jaxs():
    def flags(path):
        return set(re.findall(r'add_argument\("(--[a-z-]+)"',
                              path.read_text()))
    assert flags(Path(dryrun.__file__)) == flags(
        ROOT / "src" / "repro" / "launch" / "dryrun.py")
    with pytest.raises(SystemExit, match="mla-cache"):
        dryrun.main(["--arch", "olmo-1b", "--mla-cache", "seq"])
    assert dryrun.OUT_DIR.parts[-2:] == ("experiments", "dryrun_torch")


@pytest.mark.parametrize("arch", sorted(tconfigs.ARCHS))
def test_abstract_params_is_inits_tree_on_meta(arch):
    cfg = tconfigs.reduced(tconfigs.get(arch))
    real = lm.init(cfg, device="cpu")
    meta = lm.abstract_params(cfg)
    assert [(tuple(x.shape), x.dtype) for x in tree.leaves(meta)] == [
        (tuple(x.shape), x.dtype) for x in tree.leaves(real)]
    assert all(x.device.type == "meta" for x in tree.leaves(meta))
    with lm.unrolled_scans():
        assert [tuple(x.shape) for x in
                tree.leaves(lm.abstract_params(cfg))] == [
            tuple(x.shape) for x in tree.leaves(meta)]


def test_run_makes_only_the_bounded_roofline_records(tmp_path, monkeypatch):
    """``benchmarks.run``'s roofline rows in a checkout with no records:
    the decode cells and the cells an arch does not apply to are made
    (seconds), every other cell gets a ``no_record`` row naming the
    command that makes it, and no row is ``skipped``."""
    from repro_torch.benchmarks import roofline, run
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    monkeypatch.setattr(roofline, "DRYRUN_DIR", tmp_path)
    counted = []

    def fake(cfg, shape, mesh, **options):
        counted.append(shape.kind)
        return {"flops": 1e12, "bytes": 1e12, "ops": 1}

    monkeypatch.setattr(dryrun, "count_cell", fake)
    rows = run.roofline_rows()
    assert counted and set(counted) == {"decode"}
    made = {p.name.split("__")[1] for p in (tmp_path / "single").iterdir()}
    assert made >= {"decode_32k", "long_500k"}
    missing = [r for r in rows if "/no_record," in r]
    want = [f"{a}/{s}" for a in sorted(tconfigs.ARCHS) for s in SHAPES
            if SHAPES[s].kind != "decode"
            and applicable(dryrun.cell_config(a), SHAPES[s])[0]]
    assert [r.split(",")[0][len("roofline/"):-len("/no_record")]
            for r in missing] == want
    assert all(f"--arch {w.split('/')[0]} --shape {w.split('/')[1]}" in r
               for w, r in zip(want, missing))
    assert len(rows) - len(missing) == sum(
        roofline.roofline(json.loads(p.read_text())) is not None
        for p in (tmp_path / "single").iterdir())
    assert not any("skipped" in r for r in rows)
