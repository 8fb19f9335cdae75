"""Tensor-parallel execution of the port under the partitioner, on the CPU.

The model on ``DTensor`` weights (``sharding.partition.shard_params``) on
a 2 × 2 ("data", "model") mesh against the same step on plain tensors:

* **Sharded steps.**  One 4-rank gloo group (``tests/torch_ranks.py``,
  task ``tp``) runs each case on reduced float32 configs, sharded and
  unsharded in the same rank process: olmo-1b dense and paged decode with
  their prefills and one FSDP train step (two microbatches: loss, grad
  norm, parameters, moments), granite-34b's train step (one KV head, so
  each model rank picks its query heads' KV); deepseek-v2-lite-16b's train
  step and paged decode on MLA latent pools, its experts under the expert
  rule;
  recurrentgemma-2b and xlstm-125m decode; the fused decode + delta merge
  against the stacked step.  Logits and every cache leaf (``full_tensor``) within
  1e-5 abs + rel; greedy tokens equal wherever the reference's top-2 gap
  exceeds twice that.  Every sharded call runs under
  ``torch_ranks.refusals_of_2_11``, which raises on the ``DTensor`` ops
  PyTorch 2.11 refuses (a ``_StridedShard``, a pad), so these cases also
  hold the path to what 2.11 runs; ``-k sharded_step`` needs no JAX and is
  the check to run on a machine with 2.11.
* **Collective bytes against JAX's.**  JAX lowers and compiles the same
  programs on a (2, 2) mesh of host devices and parses the collectives of
  its HLO (``repro.launch.dryrun.collective_bytes``); the port counts them
  on a fake 4-rank group (``launch/counting.LocalCounter``).  Equal per op
  on two single-collective probes (a row-parallel product, vocab-sharded
  logits gathered) and on the coordination merge of each strategy; on
  whole reduced olmo-1b cells (``lower_cell`` / ``count_cell``) the totals
  lie in a measured band (``CELL_BAND``): the ring model makes an
  all-reduce one reduce-scatter plus one all-gather, so GSPMD's choice
  between them moves no byte, but GSPMD reduces the row-parallel outputs
  in float32 where the port's ``DTensor`` step reduces bf16 (half the
  bytes), and the train step's FSDP moves differ (the port gathers each
  weight once a use and reduce-scatters its gradient; GSPMD all-reduces
  more of them).
* **No silent fallback.**  A ``DTensor`` reaching a kernel wrapper with
  ``impl="kernel"`` raises ``ShardedKernelError``.

The three parts run at once: the gloo spawn, JAX's subprocess and the
port's counting subprocess (the fake group is its default group).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_ranks import run_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CELLS = {"decode": [128, 8, "decode"], "prefill": [64, 8, "prefill"],
         "train": [64, 8, "train"]}
# Port / JAX total collective bytes of the reduced olmo-1b cells (2 layers,
# d_model 64) on the 2 × 2 mesh: measured 0.782 (decode), 0.5 (prefill),
# 0.399 (train).
CELL_BAND = (0.35, 0.85)
B = 4

JAX_SCRIPT = r"""
import json, sys
from repro.launch import dryrun as jd  # host devices, before jax
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
import repro.configs as configs
from repro.configs.shapes import ShapeSpec
from repro.core import doc as doc_mod, gset
from repro.serving import engine
m4 = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
ns = lambda *s: NamedSharding(m4, P(*s))
out = {"probes": {}, "merge": {}, "cells": {}}
def coll(f, args, ins, outs):
    return jd.collective_bytes(jax.jit(f, in_shardings=ins,
                               out_shardings=outs).lower(*args)
                               .compile().as_text())
x, w = jnp.ones((8, 64), jnp.float32), jnp.ones((64, 32), jnp.float32)
out["probes"]["row_parallel"] = coll(
    lambda x, w: x @ w, (x, w), (ns("data", "model"), ns("model", None)),
    ns("data", None))
h, e = jnp.ones((8, 64), jnp.float32), jnp.ones((256, 64), jnp.float32)
out["probes"]["vocab_logits"] = coll(
    lambda h, e: h @ e.T, (h, e), (ns("data", None), ns("model", None)),
    ns("data", None))
for strategy in ("pmax", "allgather", "delta"):
    base = {"doc": doc_mod.empty(8, 64), "heartbeats": gset.GCounter.zeros(2)}
    if strategy == "delta":
        base = engine.with_delta_frontier(base)
    fn = engine.make_coord_merge(m4, ("data",), strategy, delta_capacity=4)
    out["merge"][strategy] = jd.collective_bytes(jax.jit(fn).lower(
        engine.replicate_coord(base, 2)).compile().as_text())
cfg = configs.reduced(configs.get("olmo-1b"), layers=2)
for name, (seq, batch, kind) in json.loads(sys.argv[1]).items():
    out["cells"][name] = jd.extrapolated_costs(
        cfg, ShapeSpec(name, seq, batch, kind), m4)["coll"]
print(json.dumps(out))
"""

PORT_SCRIPT = r"""
import json, sys
import torch
from repro_torch import configs
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core import doc as doc_mod, gset
from repro_torch.kernels import ops
from repro_torch.launch import counting, dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.serving import engine
from repro_torch.sharding.partition import P, placements, shard_tensor
META = torch.device("meta")
out = {"probes": {}, "merge": {}, "cells": {}}
with mesh_mod.debug_counting_mesh(2, 2) as mesh:
    put = lambda t, *spec: shard_tensor(t, mesh, placements(P(*spec), mesh))
    want = placements(P("data", None), mesh)
    x = put(torch.ones((8, 64), device=META), "data", "model")
    w = put(torch.ones((64, 32), device=META), "model", None)
    out["probes"]["row_parallel"] = counting.count(
        lambda: (x @ w).redistribute(mesh, want))["collectives"]
    h = put(torch.ones((8, 64), device=META), "data", None)
    e = put(torch.ones((256, 64), device=META), "model", None)
    out["probes"]["vocab_logits"] = counting.count(
        lambda: (h @ e.T).redistribute(mesh, want))["collectives"]
    for strategy in ("pmax", "allgather", "delta"):
        base = {"doc": doc_mod.empty(8, 64, device=META),
                "heartbeats": gset.GCounter.zeros(2, device=META)}
        if strategy == "delta":
            base = engine.with_delta_frontier(base)
        coord = engine.replicate_coord(base, 1)
        fn = engine.make_coord_merge(mesh, ("data",), strategy,
                                     delta_capacity=4)
        out["merge"][strategy] = counting.count(
            lambda: fn(coord))["collectives"]
    cfg = configs.reduced(configs.get("olmo-1b"), layers=2)
    for name, (seq, batch, kind) in json.loads(sys.argv[1]).items():
        out["cells"][name] = dryrun.count_cell(
            cfg, ShapeSpec(name, seq, batch, kind), mesh)["collectives"]
    q = put(torch.ones((8, 4, 16)), "data", "model", None)
    kv = put(torch.ones((8, 4, 32, 16)), "data", "model", None, None)
    try:
        ops.decode_attention(q, kv, kv, torch.full((8,), 32),
                             impl="kernel")
        out["refused"] = None
    except ops.ShardedKernelError as err:
        out["refused"] = str(err)
print(json.dumps(out))
"""


def _cases() -> dict:
    rng = np.random.default_rng(0)

    def toks(*shape):
        return torch.from_numpy(rng.integers(0, 256, shape).astype(np.int32))

    two = dict(layers=2)

    def serve(kind, arch, seed, reduced=two):
        return dict(kind=kind, arch=arch, reduced=reduced, seed=seed,
                    token=toks(B), pos=torch.full((B,), 8, dtype=torch.int32),
                    max_len=16, steps=3, prompt=toks(B, 8))

    mask = (rng.random((B, 8)) > 0.2).astype(np.float32)
    return {
        "olmo_dense": serve("dense", "olmo-1b", 1),
        "olmo_paged": serve("paged", "olmo-1b", 1),
        "olmo_train": dict(kind="train", arch="olmo-1b", reduced=two, seed=2,
                           microbatches=2,
                           batch=dict(tokens=toks(B, 8), targets=toks(B, 8),
                                      loss_mask=torch.from_numpy(mask))),
        # One KV head: every model rank picks its query heads' KV.
        "granite_train": dict(kind="train", arch="granite-34b", reduced=two,
                              seed=7, microbatches=1,
                              batch=dict(tokens=toks(B, 8),
                                         targets=toks(B, 8),
                                         loss_mask=torch.ones((B, 8)))),
        "dsv2_train": dict(kind="train", arch="deepseek-v2-lite-16b",
                           reduced=two, seed=8, microbatches=1,
                           batch=dict(tokens=toks(B, 8), targets=toks(B, 8),
                                      loss_mask=torch.ones((B, 8)))),
        "dsv2_paged": serve("paged", "deepseek-v2-lite-16b", 3),
        "rg_dense": serve("dense", "recurrentgemma-2b", 4, dict(layers=3)),
        "xlstm_dense": serve("dense", "xlstm-125m", 5),
        "fused_delta": dict(kind="fused", reduced=two, seed=6, token=toks(B),
                            max_len=16, steps=3,
                            slots=torch.arange(B, dtype=torch.int32),
                            active=torch.ones(B, dtype=torch.bool),
                            doc=(8, 64), capacity=2),
    }


CASES = list(_cases())


@pytest.fixture(scope="module")
def counters():
    """JAX's and the port's counting subprocesses, started before the
    gloo spawn so that they run beside it."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    cells = json.dumps(CELLS)
    procs = [subprocess.Popen([sys.executable, "-c", script, cells],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for script in (JAX_SCRIPT, PORT_SCRIPT)]
    try:
        yield procs
    finally:
        for p in procs:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def ranks(counters, tmp_path_factory):
    """Each rank's results of the sharded cases (no JAX: ``-k
    sharded_step`` runs where JAX is not installed)."""
    return run_ranks("tp", _cases(), tmp_path_factory.mktemp("tp"))


@pytest.fixture(scope="module")
def results(counters):
    """(JAX's collective bytes, the port's)."""
    outs = [p.communicate(timeout=300) for p in counters]
    for p, (_, err) in zip(counters, outs):
        assert p.returncode == 0, err[-3000:]
    return tuple(json.loads(out.splitlines()[-1]) for out, _ in outs)


@pytest.mark.parametrize("case", CASES)
def test_sharded_step_matches_unsharded(ranks, case):
    for rank, out in enumerate(ranks):
        got = out[case]
        assert got == ranks[0][case], (rank, got)
        for key, value in got.items():
            if isinstance(value, bool):
                assert value, (case, key)
            else:
                assert value <= 1.0, (case, key, value)


@pytest.mark.parametrize("probe", ["row_parallel", "vocab_logits"])
def test_probe_collectives_equal_jax(results, probe):
    jax_side, port = results
    assert port["probes"][probe] == jax_side["probes"][probe]
    assert port["probes"][probe]["total"] > 0


@pytest.mark.parametrize("strategy", ["pmax", "allgather", "delta"])
def test_coord_merge_collectives_equal_jax(results, strategy):
    jax_side, port = results
    assert port["merge"][strategy] == jax_side["merge"][strategy]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_collectives_within_band_of_jax(results, cell):
    jax_side, port = results
    ratio = port["cells"][cell]["total"] / jax_side["cells"][cell]["total"]
    assert CELL_BAND[0] <= ratio <= CELL_BAND[1], ratio


def test_kernel_wrapper_refuses_a_dtensor(results):
    _, port = results
    assert port["refused"] and "impl='ref'" in port["refused"]
