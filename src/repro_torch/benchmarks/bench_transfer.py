"""Times the port's two copying kernels on one CUDA card: ``page_transfer``
as a disaggregated pull calls it, and ``delta_apply`` at ``bench_merge``'s
bank.

  python src/repro_torch/benchmarks/bench_transfer.py [--src DIR]
                                                      [--disagg] [--slices]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (by
default the tree this file lives in), so one call can time two trees in
turns (parent, change, change, parent) on the same card.  The shapes,
lanes, timers and the disaggregated run are ``chip_smoke.py``'s, loaded
from this file's checkout once the timed tree's ``repro_torch`` is
imported, so they run on that tree.  Each line of output is one JSON
object; the last names the card and its power limit.  Without a card it
exits with code 2.

Rows:
  * ``pulled_page`` (bf16, int8): one page of OLMo-1B's paged caches (16
    layers; K and V pools [513, 16, 16, 128], int8 with f32 scales [513,
    16, 16]) copied between two caches by ``copy_pages_across``, as a pull
    does: the launches it makes and its host ms with a synchronize; the
    device ms of the same ``page_transfer`` launches with the ids already
    on the card (``copy_pages_across`` copies them there and synchronizes,
    which a timed trace cannot hold): one ``ops.page_transfer_leaves``
    call, or one ``ops.page_transfer`` call a leaf in a tree before the
    leaf table; and the device ms of ``export_pages`` of the page (the
    snapshot a pull takes for its rollback).  The rows are checked
    bitwise.
  * ``page_transfer``: ``ops.page_transfer`` at ``chip_smoke.py``'s kernel
    row (OLMo-1B bf16 pools of 513 and 400 pages; one lane, and 64 lanes
    with -1 lanes, destinations past the pool and duplicates).
  * ``delta_apply`` at ``bench_merge.KERNEL_SHAPE`` on
    ``bench_merge.kernel_inputs``: device ms, the device ms of
    ``key.clone()`` plus ``pay.clone()`` (the bytes' copy floor, not a
    call that computes the same function), and ``bench_merge``'s kernel
    rows (µs a call, host-synchronized).
  * ``--disagg``: ``chip_smoke.py``'s disaggregated OLMo-1B run (adoption
    on): median step, gossip host s a step, launches, host ms a pull.
  * ``--slices`` (this file's tree only): the pulled pages and the kernel
    rows on copies of ``csrc/page_transfer.cu`` whose accesses a thread
    ``U`` is patched to 1, 2, 4 and 8 (slices of 4, 8, 16 and 32 KB at
    16-byte accesses), each built with nvcc; with ptxas' register and
    spill lines.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[3]
PAGE = 37                          # the pulled page (one global id space)
ACCESSES = (1, 2, 4, 8)            # --slices: U of csrc/page_transfer.cu


def _smoke():
    """``chip_smoke.py`` of this checkout, as a module (its ``main`` does
    not run)."""
    spec = importlib.util.spec_from_file_location("_bench_chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def emit(tree: str, row: str, **fields) -> None:
    print(json.dumps(dict(row=row, tree=tree, **fields)), flush=True)


def _olmo_caches(kv_quant: str) -> tuple[list, list]:
    """Two OLMo-1B paged caches whose pool leaves hold seeded random
    bytes, and their leaves in layer order."""
    from repro_torch import configs
    from repro_torch.models import cache as cache_mod
    from repro_torch.models import lm
    cfg = configs.get("olmo-1b")
    caches, leaves = [], []
    for seed in range(2):
        c = lm.init_cache(cfg, 4, 1024, paged=True, page_size=16,
                          num_pages=513, kv_quant=kv_quant, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(seed)
        pools = [layer[name] for _, layout, layer in cache_mod.iter_layers(c)
                 for name in cache_mod.pool_leaves(layout)]
        for pool in pools:
            raw = pool.view(torch.uint8)
            raw.copy_(torch.randint(0, 256, raw.shape, generator=gen,
                                    dtype=torch.uint8, device="cuda"))
        caches.append(c)
        leaves.append(pools)
    return caches, leaves


def pulled_page_rows(smoke, tree: str) -> dict:
    """The two pulled-page rows; returns {tag: the pull's kernel call} for
    ``--slices``."""
    from repro_torch.kernels import ops
    from repro_torch.models import cache as cache_mod
    ids = torch.tensor([PAGE], dtype=torch.int32, device="cuda")
    calls = {}
    for quant, tag in (("off", "bf16"), ("int8", "int8")):
        (src_c, dst_c), (src_l, dst_l) = _olmo_caches(quant)
        pairs = list(zip(src_l, dst_l))
        before = ops.launch_counts()["page_transfer"]
        cache_mod.copy_pages_across(src_c, dst_c, [PAGE])
        torch.cuda.synchronize()
        launches = ops.launch_counts()["page_transfer"] - before
        if not all(torch.equal(d[PAGE].view(torch.uint8),
                               s[PAGE].view(torch.uint8)) for s, d in pairs):
            smoke.fail(f"pulled page {tag}: rows differ")
        if hasattr(ops, "page_transfer_leaves"):
            def kernels(pairs=pairs):
                ops.page_transfer_leaves(pairs, ids, ids)
        else:
            def kernels(pairs=pairs):
                for s, d in pairs:
                    ops.page_transfer(s, d, ids, ids)
        calls[tag] = kernels
        emit(tree, "pulled_page", pools=tag, leaves=len(pairs),
             launches=launches,
             host_ms=smoke.host_ms(lambda: cache_mod.copy_pages_across(
                 src_c, dst_c, [PAGE]), 50),
             device_ms=smoke.kernel_device_ms(kernels, "transfer"),
             export_device_ms=smoke.kernel_device_ms(
                 lambda: cache_mod.export_pages(dst_c, ids), ""))
    return calls


def page_transfer_rows(smoke, tree: str) -> dict:
    """The kernel rows; returns {lanes: the call} for ``--slices``."""
    from repro_torch.kernels import ops
    row_shape, dtype = smoke.XFER_ROWS["olmo_bf16"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    src = torch.randn((smoke.XFER_PAGES,) + row_shape, generator=gen,
                      device="cuda").to(dtype)
    dst = torch.zeros((smoke.XFER_DST_PAGES,) + row_shape, dtype=dtype,
                      device="cuda")
    calls = {}
    for s, d in smoke._xfer_lanes(np.random.default_rng(0)):
        si, di = (torch.as_tensor(x, dtype=torch.int32, device="cuda")
                  for x in (s, d))
        calls[f"{len(s)}_lanes"] = fn = (
            lambda si=si, di=di: ops.page_transfer(src, dst, si, di))
        emit(tree, "page_transfer", lanes=len(s),
             device_ms=smoke.kernel_device_ms(fn, "transfer"))
    return calls


def delta_apply_row(smoke, tree: str) -> None:
    from repro_torch.benchmarks import bench_merge
    from repro_torch.kernels import ops, ref
    key, pay, idx, dkey, dpay = bench_merge.kernel_inputs("cuda")
    got = ops.delta_apply(key, pay, idx, dkey, dpay)
    want = ref.delta_apply(key, pay, idx, dkey, dpay)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        smoke.fail("delta_apply disagrees with its plain version")
    emit(tree, "delta_apply", shape=list(bench_merge.KERNEL_SHAPE),
         device_ms=smoke.kernel_device_ms(
             lambda: ops.delta_apply(key, pay, idx, dkey, dpay),
             "delta_apply_rows"),
         copy_floor_device_ms=smoke.kernel_device_ms(
             lambda: (key.clone(), pay.clone()), ""),
         bench_merge_rows=list(bench_merge.kernel_rows()))


def disagg_row(smoke, tree: str) -> None:
    from repro_torch import configs
    from repro_torch.models import lm
    cfg = configs.get(smoke.workload.ARCH)
    params = lm.init(cfg, seed=0, device="cuda")
    rep = smoke._disagg_run(cfg, params, "cuda")["report"]
    emit(tree, "disagg", **{k: rep[k] for k in (
        "steps", "median_step_s", "wall_s", "gossip_host_s_per_step",
        "transferred_pages", "page_transfer_launches", "pull_host_ms",
        "export_host_ms")})


def slice_rows(smoke, tree: str, calls: dict) -> None:
    """``calls`` timed on patched builds of ``csrc/page_transfer.cu``, one
    for each ``U`` of ``ACCESSES``, loaded in place of the tree's."""
    from repro_torch.kernels import build
    from repro_torch.kernels import page_transfer as kxfer
    text = (build.CSRC / "page_transfer.cu").read_text()
    anchor = "constexpr int U = 2;"
    if anchor not in text:
        smoke.fail(f"csrc/page_transfer.cu has no {anchor!r} to patch")
    with tempfile.TemporaryDirectory() as tmp:
        for header in build.CSRC.glob("*.cuh"):
            shutil.copy(header, tmp)
        for u in ACCESSES:
            src = Path(tmp, f"page_transfer_u{u}.cu")
            src.write_text(text.replace(anchor, f"constexpr int U = {u};"))
            so = src.with_suffix(".so")
            log = subprocess.run([build.nvcc(), *build.FLAGS, "-o", str(so),
                                  str(src)], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True,
                                 check=True).stdout
            build._loaded[kxfer.NAME] = build.open_lib(so, kxfer.NAME,
                                                       kxfer._ARGTYPES)
            emit(tree, "slices", accesses=u, slice_kb=u * 4,
                 ptxas=re.findall(r"Used \d+ registers.*|\d+ bytes spill "
                                  r"stores.*", log),
                 **{k: smoke.kernel_device_ms(fn, "transfer")
                    for k, fn in calls.items()})
    build._loaded.pop(kxfer.NAME)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--disagg", action="store_true")
    ap.add_argument("--slices", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_transfer: no CUDA card is present", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    import repro_torch  # noqa: F401  (the timed tree, before chip_smoke)
    smoke = _smoke()
    calls = pulled_page_rows(smoke, args.src)
    calls.update(page_transfer_rows(smoke, args.src))
    delta_apply_row(smoke, args.src)
    if args.slices:
        slice_rows(smoke, args.src, calls)
    if args.disagg:
        disagg_row(smoke, args.src)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
