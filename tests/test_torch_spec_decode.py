"""Speculative decoding in the port against the JAX package, on the CPU:
the pieces below the scheduler.

The cases of tests/test_spec_decode.py that have a port counterpart (MHA,
MLA and the attention + RG-LRU hybrid; the xLSTM families are not ported),
each run in both packages on the same seeded numpy inputs and the same
weights (``convert.params_from_jax``):

* the drafters and ``accept_tokens`` give equal outputs;
* ``speculative_accept`` and the span gather / restore are bitwise equal,
  on float32, bf16, int8 and fp8 pools and on the f32 scale leaves of MHA
  and MLA; ``cache.snapshot_span`` / ``restore_span`` are bitwise equal on
  every layout the port has (dense, dense MLA, paged bf16 / int8 / fp8 MHA
  and MLA, the hybrid's state layers pruned);
* ``lm.verify_step`` at float32: preds and accept counts equal, the cache
  within 1e-4, and the rolled-back tail bitwise equal to its pre-verify
  bytes, with the continuation equal to the never-drafted greedy stream.

The scheduler's cases are in test_torch_spec_serving.py and the agent
trial's in test_torch_spec_trial.py (one file a worker, each about a
minute).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import cache as jcache  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import draft as jdraft  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import cache as tcache  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serving import draft as tdraft  # noqa: E402
from test_torch_tables import _one_thread  # noqa: E402,F401

B, MAX_LEN, PS = 3, 32, 8
V = 128


def _cfgs(kind):
    """(JAX config, port config) of one architecture the port serves."""
    def mk(pkg):
        if kind == "mha":
            return pkg.reduced(pkg.get("olmo-1b"), d_model=32,
                               vocab=V).replace(num_layers=2)
        if kind == "mla":
            return pkg.reduced(pkg.get("deepseek-v2-lite-16b"), d_model=32,
                               vocab=V).replace(block_pattern=("mla",),
                                                moe=None)
        return pkg.reduced(pkg.get("olmo-1b"), d_model=32, vocab=V).replace(
            block_pattern=("attn", "rglru"), num_layers=4)
    return mk(jconfigs), mk(tconfigs)


_MODELS: dict = {}


def _models(kind):
    """float32 weights of ``kind`` in both packages (made once)."""
    if kind not in _MODELS:
        jcfg, tcfg = _cfgs(kind)
        jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                          jlm.init(jax.random.PRNGKey(0), jcfg))
        tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                     device="cpu")
        _MODELS[kind] = (jcfg, jp, tcfg, tp)
    return _MODELS[kind]


def _tbits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits as unsigned integers (bf16 / fp8 exact)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bool:
        return t.numpy()
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[t.element_size()]
    return t.view(view).numpy().view(f"u{t.element_size()}")


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a if a.dtype == bool else a.view(f"u{a.dtype.itemsize}")


def _assert_bitwise(jax_arr, port_t, what=""):
    want, got = _jbits(jax_arr), _tbits(port_t)
    assert want.shape == got.shape, (what, want.shape, got.shape)
    assert np.array_equal(want, got), what


# ---------------------------------------------------------------------------
# Drafters and accept_tokens
# ---------------------------------------------------------------------------

def test_drafters_match_jax_on_the_reference_cases():
    ctx = [1, 2, 7, 8, 9, 4, 5, 6, 7, 8, 9]
    for c, k in ((ctx, 3), (ctx, 2), ([1, 2, 3], 4), ([], 4), (ctx, 0),
                 ([5, 1, 2, 9, 1, 2, 8, 5, 1, 2], 1)):
        assert (jdraft.NgramDrafter(max_ngram=3).propose(c, k)
                == tdraft.NgramDrafter(max_ngram=3).propose(c, k))
    live_j, live_t = [1, 2, 3], [1, 2, 3]
    dj, dt = jdraft.DocDrafter(), tdraft.DocDrafter()
    dj.set_docs([live_j])
    dt.set_docs([live_t])
    live_j.extend([4, 5])
    live_t.extend([4, 5])
    assert dj.propose([2, 3], 2) == dt.propose([2, 3], 2) == [4, 5]
    for kind in ("ngram", "doc"):
        assert jdraft.make_drafter(kind).name == \
            tdraft.make_drafter(kind).name == kind
    with pytest.raises(ValueError, match="unknown drafter kind"):
        tdraft.make_drafter("nope")
    with pytest.raises(ValueError, match="min_ngram"):
        tdraft.NgramDrafter(max_ngram=1, min_ngram=2)


@pytest.mark.parametrize("seed", range(4))
def test_drafters_and_accept_tokens_match_jax(seed):
    """Random contexts over a small alphabet (so n-grams repeat), every
    drafter shape, and random acceptance inputs."""
    rng = np.random.default_rng(seed)
    for _ in range(40):
        alpha = int(rng.integers(2, 8))
        ctx = rng.integers(0, alpha, int(rng.integers(0, 30))).tolist()
        k = int(rng.integers(0, 6))
        mx = int(rng.integers(1, 5))
        mn = int(rng.integers(1, mx + 1))
        assert (jdraft.NgramDrafter(mx, mn).propose(ctx, k)
                == tdraft.NgramDrafter(mx, mn).propose(ctx, k))
        docs = [rng.integers(0, alpha, int(rng.integers(0, 20))).tolist()
                for _ in range(int(rng.integers(0, 4)))]
        fb = bool(rng.integers(0, 2))
        dj = jdraft.DocDrafter(max_ngram=mx, min_ngram=mn, fallback=fb)
        dt = tdraft.DocDrafter(max_ngram=mx, min_ngram=mn, fallback=fb)
        dj.set_docs(docs)
        dt.set_docs(docs)
        assert dj.propose(ctx, k) == dt.propose(ctx, k)
        draft = rng.integers(0, alpha, int(rng.integers(0, 6))).tolist()
        preds = rng.integers(0, alpha, len(draft) + 1).tolist()
        acc = int(rng.integers(0, len(draft) + 2))
        remaining = int(rng.integers(0, 8))
        eos = None if rng.integers(0, 2) else int(rng.integers(0, alpha))
        assert (jdraft.accept_tokens(draft, acc, preds, remaining, eos)
                == tdraft.accept_tokens(draft, acc, preds, remaining, eos))


# ---------------------------------------------------------------------------
# speculative_accept and the span gather / restore
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", [1, 2, 5, 8])
def test_speculative_accept_bitwise(c):
    rng = np.random.default_rng(c)
    for _ in range(8):
        b = int(rng.integers(1, 7))
        tokens = rng.integers(0, 3, (b, c)).astype(np.int32)
        preds = rng.integers(0, 3, (b, c)).astype(np.int32)
        span = rng.integers(0, c + 1, b).astype(np.int32)
        want = jref.speculative_accept(jnp.asarray(preds),
                                       jnp.asarray(tokens),
                                       jnp.asarray(span))
        got = tref.speculative_accept(torch.from_numpy(preds),
                                      torch.from_numpy(tokens),
                                      torch.from_numpy(span))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _rand_leaf(rng, shape, dtype: str):
    """A seeded numpy leaf in ``dtype`` (ml_dtypes for bf16 / fp8)."""
    if dtype == "int8":
        return rng.integers(-127, 128, shape).astype(np.int8)
    x = rng.standard_normal(shape).astype(np.float32)
    if dtype == "scale":
        return np.abs(x) + 0.1
    if dtype == "float32":
        return x
    jd = {"bfloat16": jnp.bfloat16, "fp8": jnp.float8_e4m3fn}[dtype]
    return np.asarray(jnp.asarray(x).astype(jd))


# (pool shape, slot axis passed explicitly or None, leaf dtype): the MHA
# pool [P, Hkv, ps, D] and MLA pool [P, ps, Dp] in every pool dtype, and
# the f32 scale leaves, whose slot axis is passed.
SPAN_LEAVES = (
    [(f"mha_pool_{d}", (9, 2, PS, 4), None, d)
     for d in ("float32", "bfloat16", "int8", "fp8")]
    + [(f"mla_pool_{d}", (9, PS, 16), None, d)
       for d in ("float32", "bfloat16", "int8", "fp8")]
    + [("mha_scales", (9, 2, PS), 2, "scale"),
       ("mla_scales", (9, PS), 1, "scale")])


@pytest.mark.parametrize("case", range(len(SPAN_LEAVES)),
                         ids=[c[0] for c in SPAN_LEAVES])
def test_paged_span_gather_restore_bitwise(case):
    _, shape, axis, dtype = SPAN_LEAVES[case]
    rng = np.random.default_rng(case)
    pool = _rand_leaf(rng, shape, dtype)
    other = _rand_leaf(rng, shape, dtype)
    bt = rng.permutation(9)[:8].reshape(2, 4).astype(np.int32)
    bt[1, 3] = -1                               # an unallocated entry
    kw = {} if axis is None else {"slot_axis": axis}
    for start, width in (([5, 13], 4), ([0, 28], 6), ([30, 3], 8)):
        start = np.asarray(start, np.int32)
        want = jref.paged_span_gather(jnp.asarray(pool), jnp.asarray(bt),
                                      jnp.asarray(start), width, **kw)
        snap = tref.paged_span_gather(convert.to_tensor(pool, "cpu"),
                                      torch.from_numpy(bt),
                                      torch.from_numpy(start), width, **kw)
        _assert_bitwise(want, snap, "gather")
        lo = start + rng.integers(0, width, 2).astype(np.int32)
        hi = np.minimum(lo + rng.integers(0, width, 2), start + width
                        ).astype(np.int32)
        want = jref.paged_span_restore(
            jnp.asarray(other), want, jnp.asarray(bt), jnp.asarray(start),
            jnp.asarray(lo), jnp.asarray(hi), **kw)
        t_other = convert.to_tensor(other, "cpu")
        got = tref.paged_span_restore(
            t_other, snap, torch.from_numpy(bt), torch.from_numpy(start),
            torch.from_numpy(lo), torch.from_numpy(hi), **kw)
        assert got is t_other                    # in place
        _assert_bitwise(want, got, "restore")
        # The snapshot is a copy: writing the pool leaves it as it was.
        before = _tbits(snap).copy()
        t_other.view({1: torch.uint8, 2: torch.int16,
                      4: torch.int32}[t_other.element_size()]).add_(1)
        assert np.array_equal(_tbits(snap), before)


def _fill_cache(tree, rng, bt):
    """Random contents for every leaf of a JAX cache tree (numpy), block
    tables set to ``bt`` (stacked where the leaf is)."""
    def fill(path, a):
        name = path[-1].key
        a = np.asarray(a)
        if name == "block_tables":
            return np.broadcast_to(bt, a.shape).copy()
        if a.dtype == np.int8:
            return _rand_leaf(rng, a.shape, "int8")
        if name.endswith("scales"):
            return _rand_leaf(rng, a.shape, "scale")
        if a.dtype.name == "float8_e4m3fn":
            return _rand_leaf(rng, a.shape, "fp8")
        if a.dtype.name == "bfloat16":
            return _rand_leaf(rng, a.shape, "bfloat16")
        return _rand_leaf(rng, a.shape, "float32").astype(a.dtype)
    return jax.tree_util.tree_map_with_path(fill, tree)


def _jax_span_layers(jsnap, cfg) -> list:
    """A JAX snapshot tree as the port's per-layer list: stacked leaves
    are [G, B, W, ...] but for the dense K/V gather, whose separated
    advanced indices put [B, W] first: [B, W, G, Hkv, D]."""
    layers = []
    for g in range(cfg.pattern_groups):
        for i in range(len(cfg.block_pattern)):
            layers.append({n: (np.asarray(a)[:, :, g] if n in ("k", "v")
                               else np.asarray(a)[g])
                           for n, a in jsnap["groups"][str(i)].items()})
    for i in range(len(cfg.tail_blocks)):
        layers.append({n: np.asarray(a)
                       for n, a in jsnap["tail"][str(i)].items()})
    return layers


SNAP_CASES = [("mha", False, "off"), ("mha", True, "off"),
              ("mha", True, "int8"), ("mha", True, "fp8"),
              ("mla", False, "off"), ("mla", True, "off"),
              ("mla", True, "int8"), ("mla", True, "fp8"),
              ("hybrid", True, "off")]


@pytest.mark.parametrize("kind,paged,quant", SNAP_CASES)
def test_snapshot_restore_span_bitwise(kind, paged, quant):
    jcfg, tcfg = _cfgs(kind)
    rng = np.random.default_rng(SNAP_CASES.index((kind, paged, quant)))
    maxp = MAX_LEN // PS
    bt = rng.permutation(B * maxp + 1)[:B * maxp].reshape(B, maxp)
    bt = bt.astype(np.int32)
    bt[2, -1] = -1
    kw = dict(paged=paged, page_size=PS, kv_quant=quant) if paged else {}
    base = jax.tree.map(np.asarray, jlm.init_cache(jcfg, B, MAX_LEN, **kw))
    a = _fill_cache(base, rng, bt)
    c = _fill_cache(base, rng, bt)
    start = np.array([3, 17, 29], np.int32)
    width = 6
    jsnap = jcache.snapshot_span(jax.tree.map(jnp.asarray, a),
                                 jnp.asarray(start), width)
    t_a = convert.cache_from_jax(a, tcfg, device="cpu")
    tsnap = tcache.snapshot_span(t_a, torch.from_numpy(start), width)
    want = _jax_span_layers(jsnap, jcfg)
    assert len(want) == len(tsnap["layers"])
    kinds = tcache.layer_kinds(tcfg)
    for i, (w, t) in enumerate(zip(want, tsnap["layers"])):
        assert sorted(w) == sorted(t), (i, kinds[i])
        for name in w:
            _assert_bitwise(w[name], t[name], f"snapshot {i} {name}")
    lo = np.array([5, 17, 31], np.int32)
    hi = np.array([9, 17, 35], np.int32)
    jback = jcache.restore_span(jax.tree.map(jnp.asarray, c), jsnap,
                                jnp.asarray(start), jnp.asarray(lo),
                                jnp.asarray(hi))
    t_c = convert.cache_from_jax(c, tcfg, device="cpu")
    t_back = tcache.restore_span(t_c, tsnap, torch.from_numpy(start),
                                 torch.from_numpy(lo), torch.from_numpy(hi))
    want = convert.cache_from_jax(jax.tree.map(np.asarray, jback), tcfg,
                                  device="cpu")
    for i, (w, t) in enumerate(zip(want["layers"], t_back["layers"])):
        for name in w:
            assert np.array_equal(_tbits(w[name]), _tbits(t[name])), (
                i, name)
    # Something was written back, and the rows with lo == hi were not.
    assert any(not torch.equal(x, y) for lc, lt in zip(
        convert.cache_from_jax(c, tcfg, device="cpu")["layers"],
        t_back["layers"]) for x, y in zip(lc.values(), lt.values()))


# ---------------------------------------------------------------------------
# verify_step and the rollback at the lm level
# ---------------------------------------------------------------------------

def _caches(jcfg, tcfg, paged):
    kw = dict(paged=paged, page_size=PS)
    jc = jlm.init_cache(jcfg, B, MAX_LEN, dtype=jnp.float32, **kw)
    tc = tlm.init_cache(tcfg, B, MAX_LEN, dtype=torch.float32,
                        device="cpu", **kw)
    if paged:
        jc = jlm.set_block_tables(
            jc, jattn.default_block_tables(B, MAX_LEN, PS))
        tc = tlm.set_block_tables(
            tc, tattn.default_block_tables(B, MAX_LEN, PS, "cpu"))
    return jc, tc


def _assert_caches_close(jc, tc, tcfg, atol):
    want = convert.cache_from_jax(jax.tree.map(np.asarray, jc), tcfg,
                                  device="cpu")
    for i, (w, t) in enumerate(zip(want["layers"], tc["layers"])):
        for name in w:
            np.testing.assert_allclose(t[name].float().numpy(),
                                       w[name].float().numpy(), atol=atol,
                                       rtol=0, err_msg=f"layer {i} {name}")


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("kind", ["mha", "mla", "hybrid"])
def test_verify_step_and_rollback_match_jax(kind, paged):
    jcfg, jp, tcfg, tp = _models(kind)
    jc, tc = _caches(jcfg, tcfg, paged)
    rng = np.random.RandomState(0)
    plen, k = 6, 4
    prompts = rng.randint(0, V, size=(B, plen)).astype(np.int32)
    z, full = np.zeros(B, np.int32), np.full(B, plen, np.int32)
    lg, jc = jlm.mixed_step(jp, jcfg, jnp.asarray(prompts), jc,
                            jnp.asarray(z), jnp.asarray(full))
    tl, tc = tlm.mixed_step(tp, tcfg, torch.from_numpy(prompts), tc,
                            torch.from_numpy(z), torch.from_numpy(full))
    t0 = np.asarray(jnp.argmax(lg, -1)).astype(np.int32)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(), t0)

    # The never-drafted greedy stream (width-1 steps), on the port.
    ref_cache = {"layers": [{n: x.clone() for n, x in layer.items()}
                            for layer in tc["layers"]]}
    stream, cur, pos = [], t0.copy(), np.full(B, plen, np.int32)
    for _ in range(10):
        lg2, ref_cache = tlm.mixed_step(
            tp, tcfg, torch.from_numpy(cur[:, None]), ref_cache,
            torch.from_numpy(pos), torch.ones(B, dtype=torch.int32))
        cur = lg2.argmax(-1).to(torch.int32).numpy()
        stream.append(cur)
        pos = pos + 1
    stream = np.stack(stream, 1)

    # Drafts: row 0 right, row 1 wrong, row 2 wrong at its third token.
    drafts = stream[:, :k].copy()
    drafts[1] = (drafts[1] + 1) % V
    drafts[2, 2] = (drafts[2, 2] + 1) % V
    toks = np.concatenate([t0[:, None], drafts], 1).astype(np.int32)
    span = np.full(B, 1 + k, np.int32)
    start = full
    pre = {"layers": [{n: x.clone() for n, x in layer.items()}
                      for layer in tc["layers"]]}
    jsnap = jcache.snapshot_span(jc, jnp.asarray(start), 1 + k)
    tsnap = tcache.snapshot_span(tc, torch.from_numpy(start), 1 + k)
    state = bool(tlm.state_layers(tcfg))
    if state:
        jst = jlm.snapshot_state_rows(jcfg, jc)
        tst = tlm.snapshot_state_rows(tcfg, tc)
    jpreds, jacc, jc = jlm.verify_step(jp, jcfg, jnp.asarray(toks), jc,
                                       jnp.asarray(start), jnp.asarray(span))
    tpreds, tacc, tc = tlm.verify_step(tp, tcfg, torch.from_numpy(toks), tc,
                                       torch.from_numpy(start),
                                       torch.from_numpy(span))
    np.testing.assert_array_equal(tpreds.numpy(), np.asarray(jpreds))
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    assert tacc.tolist() == [4, 0, 2]
    _assert_caches_close(jc, tc, tcfg, 1e-4)

    acc = tacc.numpy()
    n_app = acc + 1
    lo, hi = (start + n_app).astype(np.int32), (start + span).astype(np.int32)
    jc = jcache.restore_span(jc, jsnap, jnp.asarray(start), jnp.asarray(lo),
                             jnp.asarray(hi))
    tc = tcache.restore_span(tc, tsnap, torch.from_numpy(start),
                             torch.from_numpy(lo), torch.from_numpy(hi))
    if state:
        mask = n_app < span
        spans2 = np.where(mask, n_app, 0).astype(np.int32)
        w2 = int(spans2.max())
        jc = jlm.restore_state_rows(jcfg, jc, jst, jnp.asarray(mask))
        _, jc = jlm.mixed_step(jp, jcfg, jnp.asarray(toks[:, :w2]), jc,
                               jnp.asarray(start), jnp.asarray(spans2))
        tc = tlm.restore_state_rows(tcfg, tc, tst, torch.from_numpy(mask))
        _, tc = tlm.mixed_step(tp, tcfg, torch.from_numpy(toks[:, :w2]), tc,
                               torch.from_numpy(start),
                               torch.from_numpy(spans2))
    _assert_caches_close(jc, tc, tcfg, 1e-4)
    # The rejected tail holds its pre-verify bytes again.
    post = tcache.snapshot_span(tc, torch.from_numpy(start), 1 + k)
    want = tcache.snapshot_span(pre, torch.from_numpy(start), 1 + k)
    for lp, lw in zip(post["layers"], want["layers"]):
        for name in lp:
            for b in range(B):
                assert torch.equal(lp[name][b, n_app[b]:],
                                   lw[name][b, n_app[b]:]), (name, b)
    # The continuation is the never-drafted stream.
    cur = np.array([stream[b, acc[b]] for b in range(B)], np.int32)
    pos = (start + n_app).astype(np.int32)
    for i in range(4):
        lg3, tc = tlm.mixed_step(tp, tcfg, torch.from_numpy(cur[:, None]), tc,
                                 torch.from_numpy(pos),
                                 torch.ones(B, dtype=torch.int32))
        cur = lg3.argmax(-1).to(torch.int32).numpy()
        for b in range(B):
            assert int(cur[b]) == int(stream[b, n_app[b] + i])
        pos = pos + 1
