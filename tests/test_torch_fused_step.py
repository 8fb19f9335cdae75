"""The port's fused decode + coordination step against JAX's, on the CPU.

``engine.make_fused_serve_step`` decodes one token on every agent row,
appends each replica's rows to its own SlotDoc replica, beats every
heartbeat lane and merges the replicas through a collective:

  * R = 1 (a ``StackedMesh`` of one replica) against JAX's fused step on a
    (1, 1) CPU mesh, for the pmax, allgather and delta strategies and
    ``merge_every`` 1 and 2: tokens, positions and the coord state bitwise,
    the cache within 1e-4 (float32 weights);
  * R = 4, stacked in one process and over a 4-rank gloo group (one
    replica a rank, its 2 rows), against JAX's fused step on a (4, 2)
    mesh of 8 host devices (one subprocess running the jitted step, which
    copies each step's sharded outputs to the host and reads replicas as
    ``np.asarray(x)[i]``): coord, per-replica digests and the delta
    frontier bitwise, tokens equal.

JAX's test model: olmo-1b reduced to d_model 32 and a vocabulary of 64.
"""
from __future__ import annotations

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.core import doc as jdoc  # noqa: E402
from repro.core import gset as jgset  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import doc as tdoc  # noqa: E402
from repro_torch.core import gset as tgset  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.sharding.mesh import StackedMesh  # noqa: E402
from test_torch_crdt import assert_same  # noqa: E402
from torch_ranks import run_ranks  # noqa: E402

SRC = str(Path(__file__).resolve().parent.parent / "src")
REDUCED = dict(d_model=32, vocab=64)
B, MAX_LEN, SLOTS, CAP = 8, 16, 8, 16
ACTIVE = np.asarray([1, 1, 1, 0, 1, 1, 0, 1], bool)
STRATEGIES = ["pmax", "allgather", "delta"]
# Three steps, as JAX's own multi-device test runs: the later merges join
# merged state.
STEPS4 = 3


@pytest.fixture(scope="module")
def models():
    jcfg = jconfigs.reduced(jconfigs.get("olmo-1b"), **REDUCED)
    tcfg = tconfigs.reduced(tconfigs.get("olmo-1b"), **REDUCED)
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      jlm.init(jax.random.PRNGKey(0), jcfg))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    return jcfg, jp, tcfg, tp


def _inputs():
    token = np.arange(2, 2 + B, dtype=np.int32)
    slots = np.arange(B, dtype=np.int32) % SLOTS
    return token, slots


def _port_run(tcfg, tp, mesh, r, strategy, merge_every, steps,
              capacity=8):
    token, slots = _inputs()
    coord = {"doc": tdoc.empty(SLOTS, CAP, device="cpu"),
             "heartbeats": tgset.GCounter.zeros(r, device="cpu")}
    if strategy == "delta":
        coord = tengine.with_delta_frontier(coord)
    coord = tengine.replicate_coord(coord, r)
    step = tengine.make_fused_serve_step(
        tcfg, mesh, ("data",), merge_strategy=strategy,
        merge_every=merge_every, delta_capacity=capacity)
    cache = tlm.init_cache(tcfg, B, MAX_LEN, device="cpu")
    tok = torch.from_numpy(token.copy())
    pos = torch.zeros((B,), dtype=torch.int32)
    toks = []
    for t in range(steps):
        tok, cache, pos, coord = step(
            tp, cache, tok, pos, torch.from_numpy(slots.copy()),
            torch.from_numpy(ACTIVE.copy()), coord, t)
        toks.append(tok)
    return torch.stack(toks, 1), pos, coord, cache


@pytest.mark.parametrize("merge_every", [1, 2])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_one_replica_matches_jax_fused_step(models, strategy, merge_every):
    jcfg, jp, tcfg, tp = models
    steps = 4
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    token, slots = _inputs()
    coord = {"doc": jdoc.empty(SLOTS, CAP),
             "heartbeats": jgset.GCounter.zeros(1)}
    if strategy == "delta":
        coord = jengine.with_delta_frontier(coord)
    coord = jengine.replicate_coord(coord, 1)
    step = jax.jit(jengine.make_fused_serve_step(
        jcfg, mesh, ("data",), merge_strategy=strategy,
        merge_every=merge_every, delta_capacity=8))
    cache = jlm.init_cache(jcfg, B, MAX_LEN)
    tok, pos = jnp.asarray(token.copy()), jnp.zeros((B,), jnp.int32)
    jtoks = []
    with mesh:
        for t in range(steps):
            tok, cache, pos, coord = step(
                jp, cache, tok, pos, jnp.asarray(slots.copy()),
                jnp.asarray(ACTIVE.copy()), coord, jnp.int32(t))
            jtoks.append(np.asarray(tok))
    got_tok, got_pos, got_coord, got_cache = _port_run(
        tcfg, tp, StackedMesh((1, 1), ("data", "model")), 1, strategy,
        merge_every, steps)
    np.testing.assert_array_equal(got_tok.numpy(), np.stack(jtoks, 1))
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(pos))
    assert_same(coord, got_coord)
    # Inactive rows keep their token and position.
    assert (got_tok.numpy()[~ACTIVE] == token[~ACTIVE, None]).all()
    assert (got_pos.numpy()[~ACTIVE] == 0).all()
    want_cache = convert.cache_from_jax(jax.tree.map(np.asarray, cache),
                                        tcfg, device="cpu")
    for a, b in zip(tree.leaves(want_cache), tree.leaves(got_cache)):
        np.testing.assert_allclose(b.float().numpy(), a.float().numpy(),
                                   atol=1e-4, rtol=1e-4)


JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax, jax.numpy as jnp, numpy as np
    import repro.configs as configs
    from repro.core import doc as doc_mod, gset
    from repro.models import lm
    from repro.serving import engine

    B, MAX_LEN, SLOTS, CAP, R, STEPS = {B}, {MAX_LEN}, {SLOTS}, {CAP}, 4, {STEPS4}
    active = np.asarray({active})
    mesh = jax.make_mesh((4, 2), ("data", "model"))
    cfg = configs.reduced(configs.get("olmo-1b"), d_model=32, vocab=64)
    params = jax.tree.map(lambda x: x.astype(jnp.float32),
                          lm.init(jax.random.PRNGKey(0), cfg))
    out = {{}}
    for strategy in ("pmax", "delta"):
        coord = {{"doc": doc_mod.empty(SLOTS, CAP),
                  "heartbeats": gset.GCounter.zeros(R)}}
        if strategy == "delta":
            coord = engine.with_delta_frontier(coord)
        coord = engine.replicate_coord(coord, R)
        step = jax.jit(engine.make_fused_serve_step(
            cfg, mesh, ("data",), merge_strategy=strategy,
            delta_capacity=8))
        cache = lm.init_cache(cfg, B, MAX_LEN)
        token = jnp.arange(2, 2 + B, dtype=jnp.int32)
        pos = jnp.zeros((B,), jnp.int32)
        slots = jnp.arange(B, dtype=jnp.int32) % SLOTS
        toks = []
        with mesh:
            for t in range(STEPS):
                # Each step's outputs go back to the host: the jitted step
                # refuses its own sharded outputs as inputs on jax 0.9.0.
                token, cache, pos, coord = jax.tree.map(np.array, step(
                    params, cache, token, pos, slots, jnp.asarray(active),
                    coord, jnp.int32(t)))
                toks.append(token)
        out[strategy + "/tokens"] = np.stack(toks, 1)
        out[strategy + "/pos"] = np.asarray(pos)
        for i, leaf in enumerate(jax.tree.leaves(coord)):
            out[f"{{strategy}}/coord{{i}}"] = np.asarray(leaf)
        docs = jax.tree.map(np.asarray, coord["doc"])
        out[strategy + "/digests"] = np.asarray([
            int(doc_mod.digest(jax.tree.map(lambda x: jnp.asarray(x[i]),
                                            docs))) for i in range(R)])
    np.savez(sys.argv[1], **out)
    print("JAX_OK")
""").format(B=B, MAX_LEN=MAX_LEN, SLOTS=SLOTS, CAP=CAP, STEPS4=STEPS4,
            active=ACTIVE.tolist())


@pytest.fixture(scope="module")
def four_replicas(models, tmp_path_factory):
    """JAX's (4, 2) mesh run, the port's stacked R = 4 run and the gloo
    ranks' run, ``STEPS4`` steps each, pmax and delta."""
    _, _, tcfg, tp = models
    tmp = tmp_path_factory.mktemp("fused4")
    # JAX's run goes on while the port's two routes run.
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(tmp / "jax.npz")],
        env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin",
             "HOME": str(tmp)}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        stacked = {s: _port_run(tcfg, tp, StackedMesh((4, 2), (
            "data", "model")), 4, s, 1, STEPS4)[:3]
            for s in ("pmax", "delta")}
        token, slots = _inputs()
        ranks = run_ranks("fused", dict(
            reduced=REDUCED, params=tp, token=torch.from_numpy(token),
            slots=torch.from_numpy(slots), active=torch.from_numpy(ACTIVE),
            doc=(SLOTS, CAP), max_len=MAX_LEN, steps=STEPS4, capacity=8,
            strategies=("pmax", "delta")), tmp)
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0 and "JAX_OK" in stdout, stderr[-3000:]
    jax_out = dict(np.load(tmp / "jax.npz"))
    gloo = {}
    for s in ("pmax", "delta"):
        per = [r[s] for r in ranks]
        gloo[s] = (torch.cat([p["tokens"] for p in per]),
                   torch.cat([p["pos"] for p in per]),
                   tree.map(lambda *xs: torch.cat(xs),
                            per[0]["coord"], *[p["coord"] for p in per[1:]]))
    return jax_out, {"stacked": stacked, "gloo": gloo}


@pytest.mark.parametrize("route", ["stacked", "gloo"])
@pytest.mark.parametrize("strategy", ["pmax", "delta"])
def test_four_replicas_match_jax_on_a_host_mesh(four_replicas, route,
                                                 strategy):
    jax_out, runs = four_replicas
    tok, pos, coord = runs[route][strategy]
    np.testing.assert_array_equal(tok.numpy(),
                                  jax_out[f"{strategy}/tokens"])
    np.testing.assert_array_equal(pos.numpy(), jax_out[f"{strategy}/pos"])
    leaves = tree.leaves(coord)
    assert len(leaves) == sum(k.startswith(f"{strategy}/coord")
                              for k in jax_out)
    for i, leaf in enumerate(leaves):
        want = jax_out[f"{strategy}/coord{i}"]
        assert leaf.numpy().dtype == want.dtype
        np.testing.assert_array_equal(leaf.numpy(), want)
    digests = [int(tdoc.digest(tree.map(lambda x: x[i], coord["doc"])))
               for i in range(4)]
    assert digests == jax_out[f"{strategy}/digests"].tolist()
    assert len(set(digests)) == 1
    # Every replica observed every active agent's appends.
    np.testing.assert_array_equal(
        coord["doc"].length.numpy(),
        np.broadcast_to(np.where(ACTIVE, STEPS4, 0), (4, SLOTS)))
    if strategy == "delta":
        np.testing.assert_array_equal(
            coord["frontier"]["doc"].length.numpy(),
            coord["doc"].length.numpy())


def test_sampling_without_a_generator_raises(models):
    _, _, tcfg, tp = models
    step = tengine.make_fused_serve_step(
        tcfg, StackedMesh((2, 1), ("data", "model")), ("data",),
        temperature=0.7)
    coord = tengine.replicate_coord(
        {"doc": tdoc.empty(SLOTS, CAP, device="cpu"),
         "heartbeats": tgset.GCounter.zeros(2, device="cpu")}, 2)
    cache = tlm.init_cache(tcfg, B, MAX_LEN, device="cpu")
    token, slots = _inputs()
    args = (tp, cache, torch.from_numpy(token), torch.zeros(B, dtype=torch.int32),
            torch.from_numpy(slots), torch.ones(B, dtype=torch.bool), coord, 0)
    with pytest.raises(ValueError, match="temperature > 0 requires"):
        step(*args)
    gen = torch.Generator().manual_seed(0)
    tok, _, pos, coord = step(*args, gen=gen)
    assert tok.shape == (B,) and bool(((tok >= 0) & (tok < 64)).all())
    np.testing.assert_array_equal(coord["doc"].length.numpy(),
                                  np.ones((2, SLOTS), np.int32))
