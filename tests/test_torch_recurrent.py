"""The port's recurrent family (RG-LRU + local attention) against the JAX
package, on the CPU.

Kernel level: ``ref.linear_scan`` against JAX's oracle ``ref.linear_scan``
(bitwise: both round each step once, as a fused multiply-add), and against
JAX's Pallas kernel in interpret mode (``ops.linear_scan(use_pallas=True)``,
whose associative scan within a time block rounds otherwise: within 2e-6
of max |y|; measured ≤ 1.4e-7); ``ref.rglru`` against JAX's (float32
gates computed by two frameworks' sigmoid / softplus / exp: 1e-6).

Module level: ``rglru.forward`` (with and without ragged ``lengths``) and
``decode_step`` against JAX's on the same weights and inputs: outputs and
``h`` / ``conv`` states within the model tolerance of
tests/test_torch_model.py; span-0 rows keep their state bitwise.

Model level: reduced ``recurrentgemma-2b`` (5 layers: rglru, rglru, local
and a tail of rglru, rglru; d_model 64, window 16), JAX ``lm.init`` weights
(float32, and the native bf16 with its float32 ``log_lambda``) carried
across by ``params_from_jax``: ``forward``; ragged prefill then decode on a
dense cache, past the window (the masked windowed decode); the ring cache
under ``ring_local_cache``; chunked admission through ``mixed_step`` at
chunk 1, ps/2, ps and 2·ps with ``paged`` True and False (JAX's chunked
run is the reference: it is not bitwise across chunkings on this build,
ROADMAP.md queue 3); the state-row functions, bitwise.  The hybrid
``("attn", "rglru")`` pattern of tests/test_mixed_step.py runs its mixed
step on paged pools.  Tolerances: logits 1e-4 (float32) and 0.1 + 0.05·|x|
(bf16); caches 1e-4 and 0.0625 + 0.05·|x|; greedy tokens equal wherever
JAX's top-1/top-2 gap exceeds twice the logit tolerance.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import cache as tcache  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402

B, MAX_LEN, PS = 3, 48, 8
LOGIT_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
             "bfloat16": dict(rtol=0.05, atol=0.1)}
CACHE_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
             "bfloat16": dict(rtol=0.05, atol=0.0625)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _t(a) -> torch.Tensor:
    return convert.to_tensor(np.asarray(a), device="cpu")


# ---------------------------------------------------------------------------
# linear_scan and rglru oracles
# ---------------------------------------------------------------------------

SCAN_CASES = [
    # (B, T, D, b dtype)
    (4, 67, 96, "float32"),
    (2, 1, 32, "float32"),                  # T = 1
    (3, 13, 64, "bfloat16"),                # T not a multiple of 8, bf16 b
    (2, 130, 40, "float32"),                # past one 128-step block
]


def _scan_case(seed, b, t, d, bdtype):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.3, 1.0, (b, t, d)).astype(np.float32)
    bb = np.asarray(jnp.asarray(rng.normal(size=(b, t, d)),
                                DTYPES[bdtype][0]))
    h0 = rng.normal(size=(b, d)).astype(np.float32)
    return a, bb, h0


@pytest.mark.parametrize("case", SCAN_CASES)
def test_linear_scan_matches_jax_oracle(case):
    """Bitwise: y (in b's dtype) and h_T of the plain paths."""
    a, bb, h0 = _scan_case(0, *case)
    want_y, want_h = jax.jit(lambda *x: jops.linear_scan(
        *x, use_pallas=False))(a, bb, h0)
    got_y, got_h = tops.linear_scan(_t(a), _t(bb), _t(h0))
    assert got_y.dtype == DTYPES[case[3]][1] and got_h.dtype == torch.float32
    np.testing.assert_array_equal(convert.to_numpy(got_y),
                                  np.asarray(want_y, np.float32))
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    np.testing.assert_array_equal(
        convert.to_numpy(tref.linear_scan(_t(a), _t(bb), _t(h0))),
        np.asarray(jax.jit(jref.linear_scan)(a, bb, h0), np.float32))


@pytest.mark.parametrize("case", SCAN_CASES)
def test_linear_scan_matches_jax_pallas_interpret(case):
    """JAX's Pallas kernel in interpret mode (time padded with identity
    steps to its block): within 2e-6 of max |y|, h_T (its float32 carry)
    against the port's float32 scan the same way."""
    a, bb, h0 = _scan_case(1, *case)
    want_y, want_h = jops.linear_scan(jnp.asarray(a), jnp.asarray(bb),
                                      jnp.asarray(h0), use_pallas=True)
    y32 = tref.linear_scan(_t(a), _t(bb).float(), _t(h0))
    got_y, _ = tops.linear_scan(_t(a), _t(bb), _t(h0))
    scale = float(np.abs(np.asarray(want_y, np.float32)).max())
    tol = 2e-6 * scale
    if case[3] == "bfloat16":               # one bf16 step of |y| more
        tol += 2 ** -8 * scale
    np.testing.assert_allclose(convert.to_numpy(got_y),
                               np.asarray(want_y, np.float32), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(y32[:, -1].numpy(), np.asarray(want_h),
                               rtol=0, atol=2e-6 * scale)


def test_linear_scan_carries_across_calls():
    """Two calls on the halves of T equal one call, bit for bit."""
    a, bb, h0 = (_t(x) for x in _scan_case(2, 3, 40, 48, "float32"))
    y, h = tops.linear_scan(a, bb, h0)
    y1, h1 = tops.linear_scan(a[:, :17], bb[:, :17], h0)
    y2, h2 = tops.linear_scan(a[:, 17:], bb[:, 17:], h1)
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, h)


def test_rglru_oracle_matches_jax():
    rng = np.random.default_rng(3)
    b, t, d = 2, 21, 48
    x, ig, rg = (rng.normal(size=(b, t, d)).astype(np.float32)
                 for _ in range(3))
    lam = rng.uniform(-4.6, -0.7, d).astype(np.float32)
    h0 = rng.normal(size=(b, d)).astype(np.float32)
    want_y, want_h = jax.jit(jref.rglru)(x, ig, rg, lam, h0)
    got_y, got_h = tref.rglru(*(_t(v) for v in (x, ig, rg, lam, h0)))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The rglru module
# ---------------------------------------------------------------------------

def _cfgs(**kw):
    return (jconfigs.reduced(jconfigs.get("recurrentgemma-2b"), **kw),
            tconfigs.reduced(tconfigs.get("recurrentgemma-2b"), **kw))


@pytest.fixture(scope="module")
def models():
    """The reduced model's JAX weights: float32, and native (bf16 with a
    float32 log_lambda), each carried across to the port."""
    jcfg, tcfg = _cfgs()
    jp = jax.jit(jlm.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    out = {}
    for name, jpd in (("float32", jax.tree.map(
            lambda x: x.astype(jnp.float32), jp)), ("bfloat16", jp)):
        tp = convert.params_from_jax(jax.tree.map(np.asarray, jpd), tcfg,
                                     device="cpu")
        out[name] = (jcfg, jpd, tcfg, tp)
    out["jmixed"] = jax.jit(lambda p, t, c, s, n: jlm.mixed_step(
        p, jcfg, t, c, s, n))
    out["jdecode"] = jax.jit(lambda p, t, c, n: jlm.decode_step(
        p, jcfg, t, c, n))
    out["jprefill"] = jax.jit(lambda p, t, c, n: jlm.prefill(
        p, jcfg, t, c, lengths=n))
    return out


def _close(got, want, tol):
    np.testing.assert_allclose(convert.to_numpy(got),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rglru_forward_and_decode_match_jax(models, dtype, ragged):
    """A forward from a live state (ragged: spans 9, 0, 4 of 9), then three
    decode steps; a span-0 row keeps h and conv bit for bit."""
    jcfg, jp, tcfg, tp = models[dtype]
    jdt, tdt = DTYPES[dtype]
    jrec, trec = jp["groups"]["0"]["rec"], tp["layers"][0]["rec"]
    jrec = jax.tree.map(lambda a: a[0], jrec)
    rng = np.random.default_rng(4)
    w = jcfg.rglru_width
    h0 = rng.normal(size=(B, w)).astype(np.float32)
    conv0 = np.asarray(jnp.asarray(rng.normal(size=(B, 3, w)), jdt))
    x = np.asarray(jnp.asarray(rng.normal(size=(B, 9, jcfg.d_model)), jdt))
    lengths = np.asarray([9, 0, 4], np.int32) if ragged else None
    jc = {"h": jnp.asarray(h0), "conv": jnp.asarray(conv0)}
    tc = {"h": _t(h0), "conv": _t(conv0)}
    want, jc = jax.jit(lambda p, x, c, n: jrglru.forward(
        p, jcfg, x, c, lengths=n))(jrec, jnp.asarray(x), jc,
                                   None if lengths is None
                                   else jnp.asarray(lengths))
    got, tc = trglru.forward(trec, tcfg, _t(x), tc,
                             lengths=None if lengths is None
                             else torch.from_numpy(lengths))
    _close(got, want, CACHE_TOL[dtype])
    for name in ("h", "conv"):
        assert tc[name].dtype == convert.to_tensor(
            np.asarray(jc[name]), device="cpu").dtype
        _close(tc[name], jc[name], CACHE_TOL[dtype])
    if ragged:
        assert np.array_equal(tc["h"][1].numpy(), h0[1])
        assert torch.equal(tc["conv"][1], _t(conv0)[1])
    for step in range(3):
        x1 = np.asarray(jnp.asarray(rng.normal(size=(B, 1, jcfg.d_model)),
                                    jdt))
        want, jc = jax.jit(lambda p, x, c: jrglru.decode_step(
            p, jcfg, x, c, None))(jrec, jnp.asarray(x1), jc)
        got, tc = trglru.decode_step(trec, tcfg, _t(x1), tc)
        _close(got, want, CACHE_TOL[dtype])
        for name in ("h", "conv"):
            _close(tc[name], jc[name], CACHE_TOL[dtype])


# ---------------------------------------------------------------------------
# The reduced model
# ---------------------------------------------------------------------------

def _logits_close(want, got, dtype):
    want = np.asarray(want, np.float32)
    got = convert.to_numpy(got) if isinstance(got, torch.Tensor) else got
    tol = LOGIT_TOL[dtype]
    np.testing.assert_allclose(got, want, **tol)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * tol["atol"]
    np.testing.assert_array_equal(np.argmax(got, -1)[clear],
                                  np.argmax(want, -1)[clear])


def _caches_close(jc, tc, tcfg, dtype):
    want = convert.cache_from_jax(jax.tree.map(np.asarray, jc), tcfg,
                                  device="cpu")
    assert len(want["layers"]) == len(tc["layers"])
    for lw, lt in zip(want["layers"], tc["layers"]):
        assert lw.keys() == lt.keys()
        assert tcache.layout_of(lw) == tcache.layout_of(lt)
        for name in lw:
            assert lw[name].dtype == lt[name].dtype, name
            np.testing.assert_allclose(convert.to_numpy(lt[name]),
                                       convert.to_numpy(lw[name]),
                                       **CACHE_TOL[dtype])


def _caches(jcfg, tcfg, dtype, paged, max_len=MAX_LEN):
    jdt, tdt = DTYPES[dtype]
    jc = jlm.init_cache(jcfg, B, max_len, dtype=jdt, paged=paged,
                        page_size=PS)
    tc = tlm.init_cache(tcfg, B, max_len, tdt, paged=paged, page_size=PS,
                        device="cpu")
    if paged:
        jc = jlm.set_block_tables(jc, jattn.default_block_tables(
            B, max_len, PS))
        tc = tlm.set_block_tables(tc, tattn.default_block_tables(
            B, max_len, PS))
    return jc, tc


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_forward_matches_jax(models, dtype):
    jcfg, jp, tcfg, tp = models[dtype]
    toks = np.random.default_rng(0).integers(0, 256, (B, 24)).astype(
        np.int32)
    want = jax.jit(lambda p, t: jlm.forward(p, jcfg, t)[0])(
        jp, jnp.asarray(toks))
    got, _ = tlm.forward(tp, tcfg, torch.from_numpy(toks))
    _logits_close(want, got, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_prefill_then_decode_matches_jax(models, dtype):
    """Ragged prefill (lengths 12, 5, 8: inside the window of 16), then 12
    teacher-forced decode steps that carry every row past the window, on
    the dense cache: the local layer's masked windowed decode (S = 48 >
    window) and the recurrent layers' O(1) update."""
    jcfg, jp, tcfg, tp = models[dtype]
    jc, tc = _caches(jcfg, tcfg, dtype, paged=False)
    assert [tcache.layout_of(l) for l in tc["layers"]] == [
        "state", "state", "dense", "state", "state"]
    toks = np.random.default_rng(1).integers(0, 256, (B, 12)).astype(
        np.int32)
    lengths = np.asarray([12, 5, 8], np.int32)
    want, jc = models["jprefill"](jp, jnp.asarray(toks), jc,
                                  jnp.asarray(lengths))
    got, tc = tlm.prefill(tp, tcfg, torch.from_numpy(toks), tc,
                          lengths=torch.from_numpy(lengths))
    _logits_close(want, got, dtype)
    _caches_close(jc, tc, tcfg, dtype)
    pos = lengths.copy()
    for _ in range(12):
        tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
        want, jc = models["jdecode"](jp, jnp.asarray(tok), jc,
                                     jnp.asarray(pos))
        got, tc = tlm.decode_step(tp, tcfg, torch.from_numpy(tok), tc,
                                  torch.from_numpy(pos))
        _logits_close(want, got, dtype)
        pos = pos + 1
    assert pos.min() > jcfg.window
    _caches_close(jc, tc, tcfg, dtype)


def test_ring_local_cache_matches_jax(models):
    """``ring_local_cache``: the local layer's cache is the window (4
    slots); a prompt of 6 (the ring gather) and 6 decode steps (the wrap),
    as tests/test_models_smoke.py's ring parity test."""
    jcfg, jp, tcfg, tp = models["float32"]
    jcfg, tcfg = (c.replace(window=4, ring_local_cache=True)
                  for c in (jcfg, tcfg))
    jc = jlm.init_cache(jcfg, 1, 14, dtype=jnp.float32)
    tc = tlm.init_cache(tcfg, 1, 14, torch.float32, device="cpu")
    assert tc["layers"][2]["k"].shape[2] == 4
    toks = np.random.default_rng(6).integers(0, 256, (1, 12)).astype(
        np.int32)
    jprefill = jax.jit(lambda p, t, c: jlm.prefill(p, jcfg, t, c))
    jdecode = jax.jit(lambda p, t, c, n: jlm.decode_step(p, jcfg, t, c, n))
    want, jc = jprefill(jp, jnp.asarray(toks[:, :6]), jc)
    got, tc = tlm.prefill(tp, tcfg, torch.from_numpy(toks[:, :6]), tc)
    _logits_close(want, got, "float32")
    pos = np.asarray([6], np.int32)
    for i in range(6):
        want, jc = jdecode(jp, jnp.asarray(toks[:, 6 + i]), jc,
                           jnp.asarray(pos))
        got, tc = tlm.decode_step(tp, tcfg, torch.from_numpy(toks[:, 6 + i]),
                                  tc, torch.from_numpy(pos))
        _logits_close(want, got, "float32")
        pos = pos + 1
    _caches_close(jc, tc, tcfg, "float32")
    with pytest.raises(NotImplementedError, match="ring local cache"):
        tlm.mixed_step(tp, tcfg, torch.zeros(1, 2, dtype=torch.int32), tc,
                       torch.zeros(1, dtype=torch.int32),
                       torch.ones(1, dtype=torch.int32))


def _admit(models, dtype, jc, tc, chunk, prompts, lengths, jmixed):
    """Stream a ragged prompt batch in through mixed steps of ``chunk``;
    every live row's logits are held to JAX's."""
    jcfg, jp, tcfg, tp = models[dtype]
    filled = np.zeros(len(lengths), np.int32)
    while (filled < lengths).any():
        span = np.minimum(chunk, lengths - filled).clip(0).astype(np.int32)
        toks = np.zeros((len(lengths), chunk), np.int32)
        for b in range(len(lengths)):
            toks[b, :span[b]] = prompts[b, filled[b]:filled[b] + span[b]]
        want, jc = jmixed(jp, jnp.asarray(toks), jc, jnp.asarray(filled),
                          jnp.asarray(span))
        got, tc = tlm.mixed_step(tp, tcfg, torch.from_numpy(toks), tc,
                                 torch.from_numpy(filled),
                                 torch.from_numpy(span))
        live = span > 0
        _logits_close(np.asarray(want, np.float32)[live],
                      convert.to_numpy(got)[live], dtype)
        filled = filled + span
    return jc, tc


@pytest.mark.parametrize("chunk", [1, PS // 2, PS, 2 * PS])
@pytest.mark.parametrize("paged", [False, True])
def test_chunked_admission_matches_jax(models, paged, chunk):
    """A ragged batch (26, 3, 11 tokens: row 0 past the window) through
    mixed steps of ``chunk`` (the recurrent layers' ragged forward over
    identity-padded spans, the local layer's windowed masks), then the
    caches."""
    jcfg, _, tcfg, _ = models["float32"]
    jc, tc = _caches(jcfg, tcfg, "float32", paged)
    rng = np.random.default_rng(2)
    lengths = np.asarray([26, 3, 11], np.int32)
    prompts = rng.integers(0, 256, (B, 26)).astype(np.int32)
    jc, tc = _admit(models, "float32", jc, tc, chunk, prompts, lengths,
                    models["jmixed"])
    _caches_close(jc, tc, tcfg, "float32")


def test_chunked_admission_matches_jax_bf16(models):
    """The served dtype: bf16 weights (float32 log_lambda), a bf16 cache."""
    jcfg, _, tcfg, _ = models["bfloat16"]
    jc, tc = _caches(jcfg, tcfg, "bfloat16", True)
    rng = np.random.default_rng(3)
    lengths = np.asarray([20, 7, 13], np.int32)
    prompts = rng.integers(0, 256, (B, 20)).astype(np.int32)
    jc, tc = _admit(models, "bfloat16", jc, tc, PS, prompts, lengths,
                    models["jmixed"])
    _caches_close(jc, tc, tcfg, "bfloat16")


def test_state_rows_match_jax(models):
    """reset / snapshot / restore of the recurrent rows, bitwise against
    JAX's on the same cache; attention layers untouched."""
    jcfg, jp, tcfg, tp = models["float32"]
    jc, tc = _caches(jcfg, tcfg, "float32", False)
    toks = np.random.default_rng(5).integers(0, 256, (B, 10)).astype(
        np.int32)
    _, jc = jax.jit(lambda p, t, c: jlm.prefill(p, jcfg, t, c))(
        jp, jnp.asarray(toks), jc)
    tc = convert.cache_from_jax(jax.tree.map(np.asarray, jc), tcfg,
                                device="cpu")
    mask = np.asarray([True, False, True])
    jsnap = jlm.snapshot_state_rows(jcfg, jc)
    tsnap = tlm.snapshot_state_rows(tcfg, tc)
    jr = jax.jit(lambda c, m: jlm.reset_state_rows(jcfg, c, m))(
        jc, jnp.asarray(mask))
    tr = tlm.reset_state_rows(tcfg, tc, torch.from_numpy(mask))
    want = convert.cache_from_jax(jax.tree.map(np.asarray, jr), tcfg,
                                  device="cpu")
    for lw, lt, lo in zip(want["layers"], tr["layers"], tc["layers"]):
        for name in lw:
            assert torch.equal(lt[name], lw[name]), name
        if tcache.layout_of(lt) == "state":
            assert not lt["h"][0].any() and torch.equal(lt["h"][1],
                                                        lo["h"][1])
    jb = jax.jit(lambda c, n, m: jlm.restore_state_rows(jcfg, c, n, m))(
        jr, jsnap, jnp.asarray(mask))
    tb = tlm.restore_state_rows(tcfg, tr, tsnap, torch.from_numpy(mask))
    want = convert.cache_from_jax(jax.tree.map(np.asarray, jb), tcfg,
                                  device="cpu")
    for i, (lw, lt) in enumerate(zip(want["layers"], tb["layers"])):
        for name in lw:
            assert torch.equal(lt[name], lw[name]), (i, name)
            assert torch.equal(lt[name], tc["layers"][i][name])
    assert [s is None for s in tsnap["layers"]] == [
        False, False, True, False, False]


def test_cache_layouts_match_jax():
    """The state and windowed layouts: leaf names, shapes, dtypes and
    fills equal JAX's, paged or not (no layer of the model pages); the
    ring sizing under ``ring_local_cache``; xLSTM still names its item."""
    jcfg, tcfg = _cfgs()
    for paged in (False, True):
        jc = jlm.init_cache(jcfg, 2, 24, paged=paged, page_size=8)
        tc = tlm.init_cache(tcfg, 2, 24, paged=paged, page_size=8,
                            device="cpu")
        want = convert.cache_from_jax(jax.tree.map(np.asarray, jc), tcfg,
                                      device="cpu")
        for lw, lt in zip(want["layers"], tc["layers"]):
            assert lw.keys() == lt.keys()
            for name in lw:
                assert lw[name].dtype == lt[name].dtype, name
                assert torch.equal(lw[name], lt[name]), name
        assert tlm.get_block_tables(tc) is None
    spec = tlm.cache_specs(tcfg.replace(ring_local_cache=True), 2, 64)
    assert [s.layout for s in spec["layers"]] == [
        "state", "state", "dense", "state", "state"]
    assert spec["layers"][2].leaves[0].shape == (2, 1, 16, 16)
    for kind in ("slstm", "mlstm"):
        with pytest.raises(NotImplementedError, match="queue 1 item 11"):
            tlm.init_cache(tcfg.replace(block_pattern=(kind,)), 1, 16,
                           device="cpu")


@pytest.fixture(scope="module")
def hybrid():
    """tests/test_mixed_step.py's hybrid: full attention on paged pools
    and RG-LRU recurrence in one pattern, float32 weights."""
    cfgs = [pkg.reduced(pkg.get("olmo-1b"), d_model=32, vocab=128).replace(
        block_pattern=("attn", "rglru"), num_layers=4)
        for pkg in (jconfigs, tconfigs)]
    jp = jax.tree.map(lambda x: x.astype(jnp.float32), jax.jit(
        jlm.init, static_argnums=1)(jax.random.PRNGKey(2), cfgs[0]))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfgs[1],
                                 device="cpu")
    return {"float32": (cfgs[0], jp, cfgs[1], tp)}


@pytest.mark.parametrize("chunk", [PS // 2, 2 * PS])
def test_hybrid_mixed_step_on_paged_pools_matches_jax(hybrid, chunk):
    jcfg, _, tcfg, _ = hybrid["float32"]
    jc, tc = _caches(jcfg, tcfg, "float32", True)
    assert [tcache.layout_of(l) for l in tc["layers"]] == [
        "paged_mha", "state", "paged_mha", "state"]
    rng = np.random.default_rng(7)
    lengths = np.asarray([19, 2, 9], np.int32)
    prompts = rng.integers(0, 128, (B, 19)).astype(np.int32)
    jmixed = jax.jit(lambda p, t, c, s, n: jlm.mixed_step(p, jcfg, t, c, s,
                                                          n))
    jc, tc = _admit(hybrid, "float32", jc, tc, chunk, prompts, lengths,
                    jmixed)
    _caches_close(jc, tc, tcfg, "float32")
