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
  mesh: the port's count is what rank 0 of a fake 4-rank group runs in
  the sharded step.  FlopCounterMode's formulas count the products
  (matmuls, attention); XLA's cost analysis also counts elementwise work
  (norms, softmax, RoPE, the optimizer), which at these narrow widths is
  most of a decode step: measured 0.872 of JAX's (train) and 0.311
  (decode).
* The counter: a product sharded 16 ways counts its global FLOPs over 16
  (a ``DTensor`` op is counted at its local shapes); a recurrent scan
  counted step by step and counted once × T give equal FLOPs, bytes and
  op counts (``_scan`` and ``linear_scan``), and the shortcut refuses a
  tensor that is not on ``meta``.
* The records: status, collective bytes in JAX's layout (per op kind and
  a ``total``), incremental writes and ``--force``, a step counted once a
  process for each mesh and keyed on the cell's config, the CLI's flags
  (JAX's; ``--mla-cache`` moves the MLA cells' counts), ``lm
  .abstract_params`` (``init``'s tree on ``meta`` tensors), the no-op
  ``lm.unrolled_scans``, and ``benchmarks.run``'s roofline rows where no
  record exists yet.
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
from repro_torch.launch import counting, dryrun  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = ("single", "multi")
CELLS = [f"{a}|{s}|{m}" for m in MESHES for a in sorted(tconfigs.ARCHS)
         for s in SHAPES]
APPLICABLE = [c for c in CELLS if applicable(
    tconfigs.get(c.split("|")[0]), SHAPES[c.split("|")[1]])[0]]
# The reduced cells of the FLOP band: (shape, band of port / JAX).
BAND_CELLS = {"train": (ShapeSpec("t", 64, 8, "train"), (0.8, 1.0)),
              "decode": (ShapeSpec("d", 128, 8, "decode"), (0.25, 0.45))}
JAX_KINDS = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute", "total"}

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
    with tmesh.debug_counting_mesh(2, 2) as mesh:
        return dryrun.count_cell(cfg, shape, mesh)["flops"]


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
    coll = rec["collective_bytes_per_device"]
    assert set(coll) <= JAX_KINDS and coll["total"] > 0
    assert coll["total"] == sum(v for k, v in coll.items() if k != "total")
    assert "ring model" in rec["collective_method"]
    assert "rank 0" in rec["cost_method"]
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
    # One process counts a step once a mesh: a rank of the multi-pod mesh
    # holds half the rows of a single-pod rank, the same weight shards.
    counts: dict = {}
    multi = dryrun.run_cell("olmo-1b", "decode_32k", "multi", force=True,
                            counts=counts, **kw)
    single = dryrun.run_cell("olmo-1b", "decode_32k", "single",
                             counts=counts, **kw)
    assert len(counts) == 2
    assert 1.5 < single["flops_per_device"] / multi["flops_per_device"] <= 2
    dryrun.run_cell("olmo-1b", "decode_32k", "single", force=True,
                    counts=counts, **kw)
    assert len(counts) == 2
    # The fused step counts the coordination on top of the decode, and
    # its merge's collectives.
    fused = dryrun.run_cell("olmo-1b", "decode_32k", "single",
                            variant="fused_delta", fused_coord=True,
                            merge_strategy="delta", counts=counts, **kw)
    assert len(counts) == 3
    assert fused["bytes_per_device"] > single["bytes_per_device"]
    assert fused["options"]["merge_strategy"] == "delta"
    assert (fused["collective_bytes_per_device"]["collective-permute"]
            > 0)


def test_mla_cache_flag_moves_the_counts(tmp_path):
    """``--mla-cache`` picks the latent cache's layout: ``seq`` splits its
    positions over model instead of its features, so a decode step reads
    and sends other bytes; the analytic memory keeps JAX's default rule."""
    arch = "deepseek-v2-lite-16b"
    recs = {mode: dryrun.run_cell(arch, "decode_32k", "single",
                                  variant=mode, mla_cache=mode,
                                  out_dir=tmp_path)
            for mode in ("latent", "seq")}
    assert all(r["status"] == "ok" for r in recs.values())
    assert recs["seq"]["options"]["mla_cache"] == "seq"
    assert (recs["seq"]["bytes_per_device"]
            != recs["latent"]["bytes_per_device"])
    assert (recs["seq"]["collective_bytes_per_device"]
            != recs["latent"]["collective_bytes_per_device"])
    assert recs["seq"]["memory_analytic"] == recs["latent"]["memory_analytic"]


def test_sharded_product_counts_its_shard():
    """A [64, 2048] @ [2048, 8192] product with rows over data and columns
    over model on a 4 × 4 mesh: rank 0's FLOPs are the global ones / 16
    (``FlopCounterMode`` alone counts the global product)."""
    from repro_torch.sharding.partition import P, placements, shard_tensor
    with tmesh.counting_mesh((4, 4), ("data", "model")) as mesh:
        x = shard_tensor(torch.ones((64, 2048), device="meta"), mesh,
                         placements(P("data", None), mesh))
        w = shard_tensor(torch.ones((2048, 8192), device="meta"), mesh,
                         placements(P(None, "model"), mesh))
        got = counting.count(lambda: x @ w)
    assert got["flops"] == 2 * 64 * 2048 * 8192 / 16
    assert got["collectives"] == {}


def _scan_cases():
    """Each scan of the port at 12 steps on ``meta`` inputs."""
    from repro_torch.kernels import ref
    from repro_torch.models import xlstm
    cfg = tconfigs.reduced(tconfigs.get("xlstm-125m"))
    cells = [layer["cell"] for layer in lm.abstract_params(cfg)["layers"]]
    b, t = 2, 12

    def meta(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    x = meta(b, t, cfg.d_model, dtype=torch.bfloat16)
    return {
        "linear_scan": lambda: ref.linear_scan(meta(b, t, 16),
                                               meta(b, t, 16), meta(b, 16)),
        "slstm": lambda: xlstm.slstm_forward(cells[0], cfg, x),
        "mlstm": lambda: xlstm.mlstm_forward(cells[1], cfg, x),
    }


@pytest.mark.parametrize("case", ["linear_scan", "slstm", "mlstm"])
def test_scan_counted_once_equals_step_by_step(case):
    fn = _scan_cases()[case]
    steps = counting.count(fn, scans_once=False)
    once = counting.count(fn, scans_once=True)
    assert once == steps
    assert once["ops"] > 12


def test_scan_shortcut_refuses_real_tensors():
    from repro_torch.kernels import ref
    from repro_torch.models import scan
    a = torch.zeros((1, 3, 4))
    with pytest.raises(ValueError, match="only on meta"):
        counting.count(lambda: ref.linear_scan(a, a, a[:, 0]),
                       device=None)
    with pytest.raises(RuntimeError, match="dry run's counter"):
        with scan.counted_once(None):
            pass
    # Outside the counter a scan runs every step, on any device.
    assert ref.linear_scan(a + 1, a + 1, a[:, 0]).shape == (1, 3, 4)


def test_counts_are_keyed_on_the_cell_config(tmp_path, monkeypatch):
    """A step's counts are reused only for the same config, shape,
    options and mesh: another MoE dispatch counts anew, and so does every
    process (no record on disk lends its counts, ``--force`` or not)."""
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
    # Each mesh is counted once: its ranks hold other shards.
    dryrun.run_cell(arch, "decode_32k", "multi", counts=counts,
                    out_dir=tmp_path)
    dryrun.run_cell(arch, "decode_32k", "single", variant="same",
                    counts=counts, out_dir=tmp_path)
    assert calls == [dispatch, dispatch]
    moved = dryrun.run_cell(arch, "decode_32k", "multi", variant=other,
                            moe_dispatch=other, counts=counts,
                            out_dir=tmp_path)
    assert calls == [dispatch, dispatch, other]
    assert moved["flops_per_device"] != first["flops_per_device"] / 2
    # A new process (no ``counts``) counts again, beside the other mesh's
    # record of the same cell, and so does ``--force``.
    dryrun.run_cell(arch, "decode_32k", "multi", variant="again",
                    out_dir=tmp_path)
    dryrun.run_cell(arch, "decode_32k", "single", force=True,
                    out_dir=tmp_path)
    assert calls == [dispatch, dispatch, other, dispatch, dispatch]


def test_cli_flags_are_jaxs():
    def flags(path):
        return set(re.findall(r'add_argument\("(--[a-z-]+)"',
                              path.read_text()))
    assert flags(Path(dryrun.__file__)) == flags(
        ROOT / "src" / "repro" / "launch" / "dryrun.py")
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
