"""Prefill/decode disaggregation in the port against the JAX package, on
the CPU.

* ``ops.page_transfer`` (the plain version every CPU tensor takes) against
  JAX's oracle ``ref.page_transfer`` and its Pallas kernel in interpret
  mode: bf16, int8, fp8 and f32 scale rows, -1 lanes on both sides, an
  out-of-range destination, duplicate destinations (the last live lane
  wins, as the Pallas kernel's sequential grid gives), pools of different
  page counts — bitwise.  Plus the wrapper's contract.
* ``cache.export_pages`` / ``adopt_pages`` / ``copy_pages_across`` on
  mha, mla, int8 and fp8 caches carried over from JAX: rows and pools
  bitwise, ``bytes_moved`` equal.
* The disaggregation scenarios of tests/test_disagg.py on a two-replica
  ``MultiEngineServer`` (roles prefill, decode): adoption on against off,
  the baseline moving no bytes, an exporter crash mid-transfer rolling
  the adopter back, role validation, deterministic counters.  With float32
  weights every counter, journal digest and token stream equals JAX's (no
  tolerance: the schedule and the greedy streams agree exactly; a flip
  would show as a stream difference).  On int8 pools the frameworks'
  float32 K/V differ in their last bits, which can move a quantum, so
  there the counters must equal JAX's and the port's own streams must
  equal its local-prefill run (adoption is a copy of bits).

The MLA model is reduced deepseek-v2-lite-16b with dense FFNs (the MoE is
not ported), the same in both packages.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.kernels import page_transfer as jpxfer  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import chaos as jchaos  # noqa: E402
from repro.serving import replicated as jrep  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import cache as tcache  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serving import chaos as tchaos  # noqa: E402
from repro_torch.serving import replicated as trep  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402

# ---------------------------------------------------------------------------
# page_transfer
# ---------------------------------------------------------------------------

ROWS = {"bf16": ((16, 8, 16), ml_dtypes.bfloat16),
        "int8": ((16, 8, 16), np.int8),
        "fp8": ((16, 8, 16), ml_dtypes.float8_e4m3fn),
        "f32_scales": ((16, 8), np.float32),
        "int8_odd": ((3, 5), np.int8)}
# Lanes: live, -1 source, -1 destination, destination past the pool (9),
# a source past the pool (clipped), and destination 2 written by lanes 0
# and 5 (the later one wins), destination 4 by lanes 6 (live) and 7 (-1
# source: dropped, so 6 wins).
SRC_IDS = np.array([0, -1, 3, 5, 11, 6, 2, -1], np.int32)
DST_IDS = np.array([2, 1, -1, 9, 0, 2, 4, 4], np.int32)


def _pool(rng, pages, row, dtype):
    x = rng.standard_normal((pages,) + row).astype(np.float32) * 4
    if dtype == np.int8:
        return rng.integers(-128, 128, (pages,) + row).astype(np.int8)
    return x.astype(dtype)


@pytest.mark.parametrize("name", sorted(ROWS))
def test_page_transfer_matches_jax_bitwise(name):
    row, dtype = ROWS[name]
    rng = np.random.default_rng(len(name))
    src, dst = _pool(rng, 7, row, dtype), _pool(rng, 6, row, dtype)
    ids = (jnp.asarray(SRC_IDS), jnp.asarray(DST_IDS))
    want = np.asarray(jref.page_transfer(jnp.asarray(src), jnp.asarray(dst),
                                         *ids))
    pallas = np.asarray(jpxfer.page_transfer(
        jnp.asarray(src), jnp.asarray(dst), *ids, interpret=True))
    assert want.tobytes() == pallas.tobytes()   # the two oracles agree
    t_dst = convert.to_tensor(dst, "cpu")
    got = ops.page_transfer(convert.to_tensor(src, "cpu"), t_dst,
                            torch.from_numpy(SRC_IDS),
                            torch.from_numpy(DST_IDS))
    assert got is t_dst                        # in place
    assert got.contiguous().view(torch.uint8).numpy().tobytes() \
        == want.tobytes()


def test_page_transfer_wrapper_contract():
    a = torch.zeros((4, 2, 8))
    with pytest.raises(ValueError, match=r"pool rows do not match.*\(4, 2, 8\)"
                                         r".*\(4, 2, 4\)"):
        ops.page_transfer(a, torch.zeros((4, 2, 4)), [0], [0])
    with pytest.raises(ValueError, match="pool rows do not match"):
        ops.page_transfer(a, torch.zeros((4, 2, 8), dtype=torch.bfloat16),
                          [0], [0])
    with pytest.raises(ValueError, match="matching 1-D"):
        ops.page_transfer(a, torch.zeros((5, 2, 8)), [0, 1], [0])
    with pytest.raises(ValueError, match="matching 1-D"):
        ops.page_transfer(a, torch.zeros((5, 2, 8)), [[0]], [[0]])
    with pytest.raises(ValueError, match="share storage"):
        ops.page_transfer(a[:2], a[2:], [0], [1])
    b = torch.ones((3, 2, 8))
    assert ops.page_transfer(a, b, torch.zeros(0, dtype=torch.int32),
                             torch.zeros(0, dtype=torch.int32)) is b
    assert (b == 1).all()
    ops.page_transfer(a, b, [1], [2], impl="ref")
    assert (b[2] == 0).all() and (b[:2] == 1).all()
    with pytest.raises(ValueError, match="impl"):
        ops.page_transfer(a, b, [1], [2], impl="pallas")


# ---------------------------------------------------------------------------
# export / adopt / copy_pages_across on carried-over caches
# ---------------------------------------------------------------------------

def _olmo(pkg):
    return pkg.reduced(pkg.get("olmo-1b"), d_model=32,
                       vocab=128).replace(num_layers=2)


def _mla(pkg):
    return pkg.reduced(pkg.get("deepseek-v2-lite-16b"), layers=2,
                       d_model=32, vocab=128).replace(block_pattern=("mla",),
                                                      moe=None)


CACHES = {"mha": (_olmo, "off"), "mla": (_mla, "off"),
          "int8": (_olmo, "int8"), "fp8": (_olmo, "fp8")}


def _filled_cache(cfg, quant, pages, seed):
    """A JAX paged cache whose pools and scales hold seeded random rows."""
    rng = np.random.default_rng(seed)
    cache = jlm.init_cache(cfg, 2, 32, paged=True, page_size=8,
                           num_pages=pages, kv_quant=quant)

    def fill(path, x):
        name = jax.tree_util.keystr(path)
        if "block_tables" in name:
            return x
        return jnp.asarray(_pool(rng, 1, x.shape, np.dtype(x.dtype))[0])
    return jax.tree_util.tree_map_with_path(fill, cache)


def _pool_bytes(tcache_tree):
    return [(name, layer[name].contiguous().view(torch.uint8).numpy())
            for _, layout, layer in tcache.iter_layers(tcache_tree)
            for name in tcache.pool_leaves(layout)]


def _jax_pool_bytes(jcache_tree, cfg):
    t = convert.cache_from_jax(jax.tree.map(np.asarray, jcache_tree), cfg,
                               device="cpu")
    return _pool_bytes(t)


@pytest.mark.parametrize("family", sorted(CACHES))
def test_page_moves_match_jax_bitwise(family):
    make, quant = CACHES[family]
    jcfg, tcfg = make(jconfigs), make(tconfigs)
    # Equal page counts: JAX's check compares a stacked pool's [P, ...]
    # too (tests of differing counts are at the kernel level above).
    jsrc, jdst = _filled_cache(jcfg, quant, 7, 0), _filled_cache(jcfg, quant,
                                                                 7, 1)
    tsrc, tdst = (convert.cache_from_jax(jax.tree.map(np.asarray, c), tcfg,
                                         device="cpu") for c in (jsrc, jdst))
    src_ids, dst_ids = [3, -1, 6, 0, 2], [1, 4, 0, -1, 5]
    # copy_pages_across through JAX's Pallas kernel (interpret mode).
    jout, jbytes = jlm.copy_pages_across(jsrc, jdst, jnp.asarray(src_ids),
                                         jnp.asarray(dst_ids))
    tout, tbytes = tlm.copy_pages_across(tsrc, tdst, src_ids, dst_ids)
    assert tbytes == jbytes > 0
    for (n1, a), (n2, b) in zip(_pool_bytes(tout), _jax_pool_bytes(jout,
                                                                   tcfg)):
        assert n1 == n2 and a.tobytes() == b.tobytes(), n1
    # export from the source, adopt into the (updated) destination.
    pages = [6, 1, 0]
    jrows = jlm.export_pages(jsrc, jnp.asarray(pages))
    trows = tlm.export_pages(tsrc, pages)
    jlayers = _unstacked_rows(jrows, jcfg)
    assert list(trows) == [f"layers/{i}" for i in range(len(jlayers))]
    for tkey, jkey_leaves in zip(trows, jlayers):
        assert set(trows[tkey]) == set(jkey_leaves)
        for name, rows in trows[tkey].items():
            want = np.ascontiguousarray(jkey_leaves[name])
            assert rows.contiguous().view(torch.uint8).numpy().tobytes() \
                == convert.to_tensor(want, "cpu").contiguous().view(
                    torch.uint8).numpy().tobytes(), (tkey, name)
    targets = [4, -1, 2]
    jfinal = jlm.adopt_pages(jout, jrows, jnp.asarray(targets))
    tfinal = tlm.adopt_pages(tout, trows, targets)
    for (n1, a), (n2, b) in zip(_pool_bytes(tfinal),
                                _jax_pool_bytes(jfinal, tcfg)):
        assert n1 == n2 and a.tobytes() == b.tobytes(), n1


def _unstacked_rows(jrows, cfg):
    """JAX's export (stacked [G, N, ...] per pattern slot) as one dict per
    layer in the port's execution order."""
    out = []
    for g in range(cfg.pattern_groups):
        for i in range(len(cfg.block_pattern)):
            leaves = jrows[f"groups/{i}"]
            out.append({k: np.asarray(v)[g] for k, v in leaves.items()})
    return out


def test_page_move_errors_name_layer_and_shapes():
    cfg = _olmo(tconfigs)
    a = tlm.init_cache(cfg, 2, 32, paged=True, page_size=8, num_pages=5,
                       device="cpu")
    b = tlm.init_cache(cfg, 2, 32, paged=True, page_size=8, num_pages=5,
                       kv_quant="int8", device="cpu")
    with pytest.raises(ValueError, match="source cache has no paged_mha_q8 "
                                         "layer at layers/0 "
                                         r"\(found paged_mha\)"):
        tlm.copy_pages_across(a, b, [0])
    with pytest.raises(ValueError, match="matching 1-D"):
        tlm.copy_pages_across(a, a, [0, 1], [0])
    rows = tlm.export_pages(a, [0])
    rows["layers/1"]["k_pages"] = rows["layers/1"]["k_pages"][:, :1]
    with pytest.raises(ValueError, match=r"adopt_pages: pool leaf 'k_pages' "
                                         r"of layer layers/1 \(paged_mha\)"):
        tlm.adopt_pages(a, rows, [0])
    with pytest.raises(ValueError, match="no exported rows"):
        tlm.adopt_pages(a, {}, [0])


# ---------------------------------------------------------------------------
# The disaggregation scenarios
# ---------------------------------------------------------------------------

def _models(make, seed):
    jcfg, tcfg = make(jconfigs), make(tconfigs)
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      jlm.init(jax.random.PRNGKey(seed), jcfg))
    return jcfg, jp, tcfg, convert.params_from_jax(
        jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@pytest.fixture(scope="module")
def llms():
    return {"mha": _models(_olmo, 0), "mla": _models(_mla, 1)}


def _requests(mod, vocab, count=8, prompt_len=17, new_tokens=4, seed=11):
    rng = np.random.default_rng(seed)
    prompts = {c: [int(t) for t in rng.integers(2, vocab, prompt_len)]
               for c in "AB"}
    pattern = ("AABB" * ((count + 3) // 4))[:count]
    return [mod.Request(rid=i, prompt=list(prompts[c]),
                        max_new_tokens=new_tokens)
            for i, c in enumerate(pattern)]


def _run_disagg(mod, cfg, params, *, adopt=True, xfer_crash=False,
                replicas=2, **kw):
    """tests/test_disagg.py's arrivals: a first wave of 2, then one per
    step, so the decode tier admits after the prefill tier's publications
    gossip."""
    reqs = _requests(mod.sched, cfg.vocab_size)
    roles = ["prefill"] + ["decode"] * (replicas - 1)
    server = mod.rep.MultiEngineServer(
        cfg, params, replicas=replicas, batch=2, max_len=32, page_size=8,
        sync_every=1, chunk_size=8, roles=roles, adopt_pages=adopt, **kw)
    if xfer_crash:
        server.arm_transfer_crash(0)
    pending = list(reqs)
    for r in pending[:2]:
        server.submit(r)
    pending = pending[2:]
    while True:
        more = server.step()
        if pending:
            server.submit(pending.pop(0))
            more = True
        assert server.clock < 5_000
        if not more:
            break
    server.sync()
    return server, reqs


class _Pkg:
    def __init__(self, rep, sched):
        self.rep, self.sched = rep, sched


JAX, PORT = _Pkg(jrep, jsched), _Pkg(trep, tsched)
SCENARIOS = {"mha": ("mha", {}), "mha_off": ("mha", {"adopt": False}),
             "mla": ("mla", {}), "int8": ("mha", {"kv_quant": "int8"}),
             "int8_off": ("mha", {"kv_quant": "int8", "adopt": False})}
_JAX_RUNS: dict = {}


def _jax_run(llms, scenario):
    """One JAX run per scenario per module (JAX compiles each engine)."""
    if scenario not in _JAX_RUNS:
        fam, kw = SCENARIOS[scenario]
        jcfg, jp, _, _ = llms[fam]
        _JAX_RUNS[scenario] = _run_disagg(JAX, jcfg, jp, **kw)
    return _JAX_RUNS[scenario]


def _port_run(llms, scenario):
    fam, kw = SCENARIOS[scenario]
    _, _, tcfg, tp = llms[fam]
    return _run_disagg(PORT, tcfg, tp, device="cpu", **kw)


@pytest.mark.parametrize("scenario", ["mha", "mla", "int8"])
def test_disagg_adoption_matches_jax(llms, scenario):
    """Adoption on: every stat equal to JAX's (adopted pages, avoided
    prefill steps, transfers, bytes, sync bytes, ...), the replicas'
    digests equal JAX's, and the streams equal JAX's (float32) or, on int8
    pools, the port's own local-prefill streams."""
    jserver, jreqs = _jax_run(llms, scenario)
    tserver, treqs = _port_run(llms, scenario)
    stats = tserver.stats()
    assert stats == jserver.stats()
    assert stats["completed"] == len(treqs) and tserver.converged()
    assert stats["adopted_pages"] > 0 and stats["prefill_steps_avoided"] > 0
    assert stats["transfer_bytes"] > 0
    assert stats["cross_replica_hits"] == stats["transferred_pages"]
    if scenario == "int8":
        _, off = _port_run(llms, "int8_off")
        assert [r.tokens for r in treqs] == [r.tokens for r in off]
    else:
        assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
        assert [s.digest() for s in tserver.stores] == [
            s.digest() for s in jserver.stores]
    for store in tserver.stores:
        assert (store.refcounts() == 0).all()
        assert (store.dec <= store.inc).all()


def test_disagg_baseline_never_moves_bytes(llms):
    """adopt_pages=False keeps publication and role routing but prefills
    locally: no transfer, same streams as adoption on, stats equal JAX's."""
    jserver, jreqs = _jax_run(llms, "mha_off")
    off, reqs_off = _port_run(llms, "mha_off")
    on, reqs_on = _port_run(llms, "mha")
    s_off = off.stats()
    assert s_off == jserver.stats()
    assert s_off["transfer_bytes"] == 0 and s_off["transferred_pages"] == 0
    assert s_off["adopted_pages"] == 0 and s_off["cross_replica_hits"] == 0
    assert on.stats()["adopted_pages"] > 0
    assert [r.tokens for r in reqs_on] == [r.tokens for r in reqs_off] \
        == [r.tokens for r in jreqs]


def _capture_aborts(cls, log, pools):
    """Wrap ``cls._pull_page``: around each pull that ends in an abort,
    record the adopter's pools before and after (``pools(server, r)``) and
    the page it tried (the ``a`` of its J_XFER_ABORT entry)."""
    orig = cls._pull_page

    def pull(self, r, rid, key, lead):
        before = pools(self, r)
        aborts = self.adopt_aborts
        out = orig(self, r, rid, key, lead)
        if self.adopt_aborts > aborts:
            st = self.stores[r]
            page = int(st.jr["a"][r, int(st.jr_count[r]) - 1])
            log.append((before, pools(self, r), page))
        return out
    return pull


def test_disagg_exporter_crash_rolls_back_bitwise(llms, monkeypatch):
    """The exporter crashes after J_XFER_BEGIN, before the commit check
    (3 replicas, so the survivors retire it).  JAX drops the transferred
    cache; the port's transfer wrote the adopter's pool in place and must
    restore it: the adopter's pools after the abort equal, bitwise, its
    pools before the pull, and equal JAX's adopter pools after the abort.
    The journal balances, every rid completes exactly once with JAX's
    stream, and stats and digests equal JAX's.  (JAX's whole pools are not
    bitwise the port's: the float32 K/V written before differ in their last
    bits; the transfer's target rows are compared.)"""
    jcfg, jp, tcfg, tp = llms["mha"]
    jlog, tlog = [], []
    monkeypatch.setattr(jrep.MultiEngineServer, "_pull_page",
                        _capture_aborts(
                            jrep.MultiEngineServer, jlog,
                            lambda s, r: _jax_pool_bytes(s.engines[r].cache,
                                                         tcfg)))
    monkeypatch.setattr(trep.MultiEngineServer, "_pull_page",
                        _capture_aborts(
                            trep.MultiEngineServer, tlog,
                            lambda s, r: _pool_bytes(s.engines[r].cache)))
    jserver, _ = _run_disagg(JAX, jcfg, jp, xfer_crash=True, replicas=3)
    tserver, treqs = _run_disagg(PORT, tcfg, tp, xfer_crash=True,
                                 replicas=3, device="cpu")
    assert tserver._xfer_crash is None and tserver.adopt_aborts >= 1
    assert len(tlog) == len(jlog) == tserver.adopt_aborts
    for (tb, ta, page), (_, ja, jpage) in zip(tlog, jlog):
        assert page == jpage
        for (n, before), (_, after), (_, want) in zip(tb, ta, ja):
            assert after.tobytes() == before.tobytes(), n
            assert after[page].tobytes() == want[page].tobytes(), n
    ok, detail = tchaos._xfer_balanced(tserver)
    assert ok, detail
    assert (ok, detail) == jchaos._xfer_balanced(jserver)
    assert tserver.stats() == jserver.stats()
    assert tserver.stats()["failed_requests"] == 0
    assert tserver.stats()["lost_requests"] == 0
    assert tserver.converged()
    assert [s.digest() for s in tserver.stores] == [s.digest()
                                                     for s in jserver.stores]
    once, _ = tchaos._exactly_once(tserver)
    assert once
    store = next(s for r, s in enumerate(tserver.stores)
                 if not tserver.crashed[r])
    jstore = next(s for r, s in enumerate(jserver.stores)
                  if not jserver.crashed[r])
    tinfo, jinfo = tserver._fold_journal(store), jserver._fold_journal(jstore)
    for req in treqs:
        assert tinfo[req.rid]["terminal"]
        assert tserver._contiguous(tinfo[req.rid]["gen"]) \
            == jserver._contiguous(jinfo[req.rid]["gen"]), req.rid


def test_disagg_role_validation(llms):
    _, _, tcfg, tp = llms["mha"]
    with pytest.raises(ValueError, match="roles must name every replica"):
        trep.MultiEngineServer(tcfg, tp, replicas=2, batch=2, max_len=32,
                               page_size=8, roles=["prefill"], device="cpu")
    with pytest.raises(ValueError, match="prefill/decode/mixed"):
        trep.MultiEngineServer(tcfg, tp, replicas=2, batch=2, max_len=32,
                               page_size=8, roles=["prefill", "verifier"],
                               device="cpu")
    with pytest.raises(ValueError, match="prefill/decode/mixed"):
        tsched.ContinuousBatchingEngine(tcfg, tp, batch=1, max_len=16,
                                        page_size=8, role="verifier",
                                        device="cpu")


def test_disagg_deterministic_counters(llms):
    """Same arrivals, same adoption accounting, run after run (and equal to
    JAX's)."""
    keys = ("adopted_pages", "prefill_steps_avoided", "transferred_pages",
            "transfer_bytes", "adopt_aborts", "cross_replica_hits", "steps",
            "sync_bytes")
    runs = [_port_run(llms, "mha")[0].stats() for _ in range(2)]
    want = _jax_run(llms, "mha")[0].stats()
    assert [tuple(s[k] for k in keys) for s in runs] == [
        tuple(want[k] for k in keys)] * 2
