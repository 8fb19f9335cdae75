"""The port's MoE FFN and the ``moe`` / ``mla_moe`` models against the JAX
package, on the CPU.

Module level: ``moe.forward`` on float32 JAX ``moe.init`` weights (the
reduced experts: 8 routed top-2 of width 32, 1 shared) against JAX's, out
within 1e-4 and the aux loss within 1e-6: the dense path (n <= E), the
gather path (n > E), a capacity factor low enough that JAX drops
assignments (checked on JAX's own routing), ``dispatch="dense"`` past E
tokens, and a router with exact ties, whose expert choice must equal
``jax.lax.top_k``'s (lowest index first).

Model level: reduced ``deepseek-moe-16b`` (``moe``: MHA + MoE) and
``deepseek-v2-lite-16b`` (``mla_moe``: MLA + MoE), 2 layers, d_model 32,
float32 JAX ``lm.init`` weights through ``params_from_jax``: forward with
its aux loss, ragged prefill then decode, chunked admission through
``mixed_step`` on float32 and int8 pools (the tolerances
of tests/test_torch_mla.py), and the scheduler's streams and counters.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import cache as tcache  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402

OUT_TOL = dict(rtol=1e-4, atol=1e-4)
AUX_TOL = dict(rtol=1e-6, atol=1e-6)
ARCHS = {"moe": "deepseek-moe-16b", "mla_moe": "deepseek-v2-lite-16b"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(kind, **moe_kw):
    out = []
    for pkg in (jconfigs, tconfigs):
        cfg = pkg.reduced(pkg.get(ARCHS[kind]), layers=2, d_model=32,
                          vocab=128)
        out.append(cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw)))
    return out


def _moe_params(jcfg, seed=0):
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jmoe.init(jax.random.PRNGKey(seed), jcfg))
    return jp, jax.tree.map(
        lambda a: convert.to_tensor(np.asarray(a), device="cpu"), jp)


def _jax_keep(jp, jcfg, x):
    """Whether each (token, k) assignment fits its expert's capacity, on
    JAX's own routing (the cumsum of ``repro.models.moe.forward``)."""
    m = jcfg.moe
    b, t, d = x.shape
    logits = (x.reshape(-1, d) @ np.asarray(jp["router"]["w"]))
    probs = jax.nn.softmax(jnp.asarray(logits, jnp.float32), -1)
    _, idx = jax.lax.top_k(probs, m.top_k)
    e_bt = np.asarray(idx).reshape(b, t * m.top_k)
    onehot = np.eye(m.num_experts, dtype=np.int64)[e_bt]
    slot = np.take_along_axis(np.cumsum(onehot, 1) - 1, e_bt[..., None],
                              2)[..., 0]
    return slot < max(int(m.capacity_factor * t * m.top_k / m.num_experts),
                      1)


CASES = {
    "dense_small_n": (dict(), (2, 3)),                 # n = 6 <= E = 8
    "gather": (dict(), (2, 16)),
    "gather_drops": (dict(capacity_factor=0.5), (3, 20)),
    "dense_dispatch": (dict(dispatch="dense"), (2, 16)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_forward_matches_jax(case):
    moe_kw, (b, t) = CASES[case]
    jcfg, tcfg = _cfgs("moe", **moe_kw)
    jp, tp = _moe_params(jcfg)
    x = np.random.default_rng(1).standard_normal(
        (b, t, jcfg.d_model)).astype(np.float32)
    want, waux = jax.jit(lambda p, x: jmoe.forward(p, jcfg, x))(
        jp, jnp.asarray(x))
    got, gaux = tmoe.forward(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    np.testing.assert_allclose(float(gaux), float(waux), **AUX_TOL)
    keep = _jax_keep(jp, jcfg, x)
    if case == "gather_drops":
        assert not keep.all(), "JAX drops no assignment in this case"
        _, tkeep = tmoe.slots(tcfg, tmoe.route(
            tp, tcfg, torch.from_numpy(x).reshape(-1, jcfg.d_model))[2], b, t)
        np.testing.assert_array_equal(tkeep.numpy(), keep)
    elif case == "gather":
        assert keep.all()


def test_top_k_keeps_lax_order_on_ties():
    """Probabilities with many exact ties: the same indices as
    ``jax.lax.top_k`` (equal values, lowest index first), values bitwise."""
    rng = np.random.default_rng(3)
    probs = rng.integers(0, 4, (64, 16)).astype(np.float32) / 4
    for k in (1, 2, 6, 16):
        wv, wi = jax.lax.top_k(jnp.asarray(probs), k)
        gv, gi = tmoe.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("t", [3, 16])
def test_moe_tied_router_matches_jax(t):
    """A router whose columns come in equal pairs, so every token's logits
    tie exactly in pairs: the routed experts equal ``lax.top_k``'s on
    JAX's probabilities, and the outputs JAX's."""
    jcfg, tcfg = _cfgs("moe")
    jp, _ = _moe_params(jcfg)
    w = np.asarray(jp["router"]["w"]).copy()
    w[:, 1::2] = w[:, 0::2]
    jp["router"]["w"] = jnp.asarray(w)
    tp = jax.tree.map(lambda a: convert.to_tensor(np.asarray(a),
                                                  device="cpu"), jp)
    x = np.random.default_rng(4).standard_normal(
        (2, t, jcfg.d_model)).astype(np.float32)
    xf = x.reshape(-1, jcfg.d_model)
    probs = jax.nn.softmax(jnp.asarray(xf @ w, jnp.float32), -1)
    _, want_idx = jax.lax.top_k(probs, jcfg.moe.top_k)
    tprobs, _, got_idx = tmoe.route(tp, tcfg, torch.from_numpy(xf))
    tied = np.asarray(tprobs)[:, 0::2] == np.asarray(tprobs)[:, 1::2]
    assert tied.all()
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    want, _ = jmoe.forward(jp, jcfg, jnp.asarray(x))
    got, _ = tmoe.forward(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


# ---------------------------------------------------------------------------
# The models
# ---------------------------------------------------------------------------

B, MAX_LEN, PS = 3, 32, 8
LAYOUTS = {"dense": (False, "off"), "paged": (True, "off"),
           "int8": (True, "int8")}
CACHE_TOL = dict(rtol=1e-4, atol=1e-4)
QUANTUM_SHARE = 0.05


@pytest.fixture(scope="module")
def models():
    out = {}
    for kind in ARCHS:
        jcfg, tcfg = _cfgs(kind)
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jax.jit(
            jlm.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg))
        tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                     device="cpu")
        out[kind] = dict(
            cfgs=(jcfg, tcfg), params=(jp, tp),
            mixed=jax.jit(lambda p, t, c, s, n, cfg=jcfg: jlm.mixed_step(
                p, cfg, t, c, s, n)),
            decode=jax.jit(lambda p, t, c, n, cfg=jcfg: jlm.decode_step(
                p, cfg, t, c, n)),
            prefill=jax.jit(lambda p, t, c, n, cfg=jcfg: jlm.prefill(
                p, cfg, t, c, lengths=n)),
            forward=jax.jit(lambda p, t, cfg=jcfg: jlm.forward(p, cfg, t)))
    return out


def _logits_close(want, got):
    want = np.asarray(want, np.float32)
    got = convert.to_numpy(got) if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, **OUT_TOL)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * OUT_TOL["atol"]
    np.testing.assert_array_equal(np.argmax(got, -1)[clear],
                                  np.argmax(want, -1)[clear])


def _caches(m, layout):
    paged, quant = LAYOUTS[layout]
    jcfg, tcfg = m["cfgs"]
    jc = jlm.init_cache(jcfg, B, MAX_LEN, dtype=jnp.float32, paged=paged,
                        page_size=PS, kv_quant=quant)
    tc = tlm.init_cache(tcfg, B, MAX_LEN, torch.float32, paged=paged,
                        page_size=PS, kv_quant=quant, device="cpu")
    if paged:
        jc = jlm.set_block_tables(jc, jattn.default_block_tables(
            B, MAX_LEN, PS))
        tc = tlm.set_block_tables(tc, tattn.default_block_tables(
            B, MAX_LEN, PS))
    return jc, tc


def _caches_close(jc, tc, tcfg):
    """Float leaves within CACHE_TOL; quantized pools after dequantization
    within CACHE_TOL or two quanta, at most QUANTUM_SHARE of the elements
    more than one quantum apart."""
    from repro_torch.kernels import ref as tref
    want = convert.cache_from_jax(jax.tree.map(np.asarray, jc), tcfg,
                                  device="cpu")
    for lw, lt in zip(want["layers"], tc["layers"]):
        assert lw.keys() == lt.keys()
        for name in lw:
            assert lw[name].dtype == lt[name].dtype, name
            sn = tcache.SCALE_LEAF.get(name)
            if name in tcache.SCALE_LEAF.values():
                continue                # held with its pool, below
            if sn not in lw:
                np.testing.assert_allclose(convert.to_numpy(lt[name]),
                                           convert.to_numpy(lw[name]),
                                           **CACHE_TOL)
                continue
            dw = tref.dequantize_rows(lw[name], lw[sn]).numpy()
            dt = tref.dequantize_rows(lt[name], lt[sn]).numpy()
            quantum = np.maximum(lw[sn].numpy(), lt[sn].numpy())[..., None]
            err = np.abs(dt - dw)
            tol = CACHE_TOL["atol"] + CACHE_TOL["rtol"] * np.abs(dw)
            assert (err <= np.maximum(tol, 2 * quantum)).all(), name
            assert float((err > quantum * (1 + 1e-6)).mean()
                         ) <= QUANTUM_SHARE


@pytest.mark.parametrize("kind", sorted(ARCHS))
def test_moe_model_forward_matches_jax(models, kind):
    """Logits and the summed aux loss (a sum over layers and experts)."""
    m = models[kind]
    (jcfg, tcfg), (jp, tp) = m["cfgs"], m["params"]
    toks = np.random.default_rng(0).integers(0, 128, (B, 12)).astype(
        np.int32)
    want, waux = m["forward"](jp, jnp.asarray(toks))
    got, gaux = tlm.forward(tp, tcfg, torch.from_numpy(toks))
    _logits_close(want, got)
    assert float(waux) > 0
    np.testing.assert_allclose(float(gaux), float(waux), **AUX_TOL)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("kind", sorted(ARCHS))
def test_moe_model_prefill_then_decode_matches_jax(models, kind, layout):
    """Ragged prefill (lengths 12, 5, 8; gather dispatch), then three
    teacher-forced decode steps (3 tokens <= 8 experts: dense dispatch)."""
    m = models[kind]
    (jcfg, tcfg), (jp, tp) = m["cfgs"], m["params"]
    jc, tc = _caches(m, layout)
    toks = np.random.default_rng(1).integers(0, 128, (B, 12)).astype(
        np.int32)
    lengths = np.asarray([12, 5, 8], np.int32)
    want, jc = m["prefill"](jp, jnp.asarray(toks), jc, jnp.asarray(lengths))
    got, tc = tlm.prefill(tp, tcfg, torch.from_numpy(toks), tc,
                          lengths=torch.from_numpy(lengths))
    _logits_close(want, got)
    pos = lengths.copy()
    for _ in range(3):
        tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
        want, jc = m["decode"](jp, jnp.asarray(tok), jc, jnp.asarray(pos))
        got, tc = tlm.decode_step(tp, tcfg, torch.from_numpy(tok), tc,
                                  torch.from_numpy(pos))
        _logits_close(want, got)
        pos = pos + 1
    _caches_close(jc, tc, tcfg)


@pytest.mark.parametrize("chunk", [1, PS])
@pytest.mark.parametrize("layout", ["paged", "int8"])
@pytest.mark.parametrize("kind", sorted(ARCHS))
def test_moe_model_mixed_step_matches_jax(models, kind, layout, chunk):
    """A ragged prompt batch (20, 3, 11 tokens) through mixed steps of
    ``chunk``: n = B·chunk tokens take the dense dispatch at chunk 1 and
    the gather dispatch at chunk 8, padding positions routed too."""
    m = models[kind]
    (jcfg, tcfg), (jp, tp) = m["cfgs"], m["params"]
    jc, tc = _caches(m, layout)
    rng = np.random.default_rng(2)
    lengths = np.asarray([20, 3, 11], np.int32)
    prompts = rng.integers(0, 128, (B, 20)).astype(np.int32)
    filled = np.zeros(B, np.int32)
    while (filled < lengths).any():
        span = np.minimum(chunk, lengths - filled).clip(0).astype(np.int32)
        toks = np.zeros((B, chunk), np.int32)
        for b in range(B):
            toks[b, :span[b]] = prompts[b, filled[b]:filled[b] + span[b]]
        want, jc = m["mixed"](jp, jnp.asarray(toks), jc,
                              jnp.asarray(filled), jnp.asarray(span))
        got, tc = tlm.mixed_step(tp, tcfg, torch.from_numpy(toks), tc,
                                 torch.from_numpy(filled),
                                 torch.from_numpy(span))
        live = span > 0
        _logits_close(np.asarray(want, np.float32)[live],
                      convert.to_numpy(got)[live])
        filled = filled + span
    _caches_close(jc, tc, tcfg)


COUNTERS = ("steps", "prefill_chunks", "admitted", "completed", "gen_tokens",
            "peak_pages", "grown_pages", "preemptions", "prefill_tokens",
            "decode_stall_steps", "preempt_recompute")


@pytest.mark.parametrize("quant", ["off", "int8"])
@pytest.mark.parametrize("kind", sorted(ARCHS))
def test_moe_scheduler_streams_and_counters_match_jax(models, kind, quant):
    """A pool too small for both rows (growth preempts); chunks of 8 take
    the gather dispatch, decode steps the dense one.  Streams equal JAX's
    on float32 pools; counters on both."""
    m = models[kind]
    (jcfg, tcfg), (jp, tp) = m["cfgs"], m["params"]
    kw = dict(batch=2, max_len=32, paged=True, page_size=8, num_pages=4,
              chunk_size=8, kv_quant=quant)
    spec = [(10, 12), (9, 12), (5, 4)]
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(2, 100, n)] for n, _ in spec]
    jeng = jsched.ContinuousBatchingEngine(jcfg, jp, **kw)
    want = jeng.run([jsched.Request(i, list(p), mx)
                     for i, (p, (_, mx)) in enumerate(zip(prompts, spec))])
    teng = tsched.ContinuousBatchingEngine(tcfg, tp, device="cpu", **kw)
    got = teng.run([tsched.Request(i, list(p), mx)
                    for i, (p, (_, mx)) in enumerate(zip(prompts, spec))])
    if quant == "off":
        for w, g in zip(want, got):
            assert g.tokens == w.tokens, g.rid
    for name in COUNTERS:
        assert teng.stats[name] == jeng.stats[name], name
    assert teng.stats["preemptions"] > 0
    assert teng.allocator.available == jeng.allocator.available
