"""Quantized page pools of the port against the JAX package, on the CPU.

* ``quantize_rows`` / ``dequantize_rows``: bitwise for int8 and fp8-e4m3,
  all-zero rows and values halfway between int8 steps included.
* The two quantized oracles (``paged_decode_attention_quant``,
  ``paged_chunk_attention_quant``) through the ``ops`` wrappers (clamps
  included): pools and scales bitwise, float32 outputs within 1e-5 at
  defined positions.
* The model with ``kv_quant`` (reduced olmo-1b, bf16) through chunked
  admission at chunk sizes 1, ps/2, ps and 2·ps and two decode steps:
  K and V differ in their last bf16 bit between the frameworks from the
  second layer on, which moves a row's scale and can move an int8 step
  or an fp8 step.  So pools are compared after dequantization: every
  element within the bf16 cache tolerance (0.0625 + 0.05·|x|) or two
  quanta, and at most ``QUANTUM_SHARE`` of the elements more than one
  quantum apart.  Logits within 0.1 + 0.05·|x| (the bf16 model
  tolerance), argmax equal where JAX's top-1/top-2 gap exceeds 0.2.
* ``ContinuousBatchingEngine(kv_quant=...)``: the schedule counters equal
  JAX's.
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
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402

QDTYPES = {"int8": (jnp.int8, torch.int8),
           "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=0.05, atol=0.1)
CACHE_TOL = dict(rtol=0.05, atol=0.0625)
# Share of dequantized pool elements allowed more than one quantum apart.
# Measured over the chunk sizes below: 0 in layer 0; in layer 1 at most
# 3.5 % (int8 V) beyond one quantum and 0.08 % beyond two.
QUANTUM_SHARE = 0.05


def _bits(t: torch.Tensor) -> np.ndarray:
    """The raw bytes of a tensor (fp8 and int8 as uint8), for bitwise
    comparisons."""
    if t.dtype in (torch.float8_e4m3fn, torch.int8):
        t = t.view(torch.uint8)
    return t.numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


def _rows(rng, n, d):
    """Random rows plus an all-zero row and rows whose values sit halfway
    between int8 steps once scaled (amax 127 maps to a scale near 1)."""
    x = rng.standard_normal((n, d)).astype(np.float32) * 3
    x[0] = 0.0
    half = (np.arange(d) % 7 - 3 + 0.5).astype(np.float32)
    half[0] = 127.0
    x[1] = half
    x[2] = -half
    x[3, : d // 2] = 1e-30                       # tiny (subnormal-scale) row
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qname", sorted(QDTYPES))
def test_quantize_rows_bitwise(qname, dtype):
    jq, tq = QDTYPES[qname]
    x = _rows(np.random.default_rng(0), 64, 32)
    if dtype == "bfloat16":
        xj = jnp.asarray(x).astype(jnp.bfloat16)
        xt = convert.to_tensor(np.asarray(xj), device="cpu")
    else:
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
    qj, sj = jref.quantize_rows(xj, jq)
    qt, st = tref.quantize_rows(xt, tq)
    np.testing.assert_array_equal(_bits(qt), _jbits(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert st[0] == 1.0                          # all-zero row: scale 1
    if qname == "int8" and dtype == "float32":
        scaled = x[1] / st[1].item()
        assert (np.abs(scaled - np.round(scaled)) == 0.5).any()
    np.testing.assert_array_equal(
        tref.dequantize_rows(qt, st).numpy(),
        np.asarray(jref.dequantize_rows(qj, sj)))


def _pools(rng, num_pages, hkv, ps, d, qname):
    """Quantized pools with real contents (quantized random rows) and
    their scales, as (jax, torch) pairs."""
    jq, _ = QDTYPES[qname]
    out = []
    for _ in range(2):
        x = rng.standard_normal((num_pages, hkv, ps, d)).astype(np.float32)
        q, s = jref.quantize_rows(jnp.asarray(x), jq)
        out.append((q, s))
    return [(q, s, convert.to_tensor(np.asarray(q), device="cpu"),
             torch.from_numpy(np.array(s))) for q, s in out]


def _table(rng, b, maxp, num_pages):
    bt = rng.permutation(num_pages)[: b * maxp].reshape(b, maxp)
    bt = bt.astype(np.int32)
    bt[1, maxp // 2:] = -1                       # unallocated tail
    return bt


CASES = [dict(ps=8, d=16, window=None), dict(ps=16, d=32, window=None),
         dict(ps=8, d=32, window=5), dict(ps=16, d=16, window=3)]


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("qname", sorted(QDTYPES))
def test_decode_quant_oracle_matches_jax(qname, case):
    ps, d, window = (CASES[case][k] for k in ("ps", "d", "window"))
    rng = np.random.default_rng(case)
    b, hq, hkv, maxp = 4, 4, 2, 4
    num_pages = b * maxp + 2
    (jk, jks, tk, tks), (jv, jvs, tv, tvs) = _pools(rng, num_pages, hkv, ps,
                                                    d, qname)
    bt = _table(rng, b, maxp, num_pages)
    pos = np.array([0, ps * maxp // 2 + 1, ps + 3, ps * maxp + 5], np.int32)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kn = rng.standard_normal((b, hkv, d)).astype(np.float32)
    vn = rng.standard_normal((b, hkv, d)).astype(np.float32)
    J = lambda a: jnp.asarray(a)
    T = lambda a: torch.from_numpy(np.array(a))
    want = jops.paged_decode_attention_quant(
        J(q), jk, jks, jv, jvs, J(bt), J(pos), J(kn), J(vn), window=window,
        use_pallas=False)
    got = tops.paged_decode_attention_quant(
        T(q), tk, tks, tv, tvs, T(bt), T(pos), T(kn), T(vn), window=window)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               **OUT_TOL)
    for w, g in zip(want[1:], got[1:]):
        np.testing.assert_array_equal(_bits(g), _jbits(w))


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("qname", sorted(QDTYPES))
def test_chunk_quant_oracle_matches_jax(qname, case):
    ps, d, window = (CASES[case][k] for k in ("ps", "d", "window"))
    rng = np.random.default_rng(10 + case)
    b, hq, hkv, maxp, c = 4, 4, 2, 4, 2 * ps
    num_pages = b * maxp + 2
    (jk, jks, tk, tks), (jv, jvs, tv, tvs) = _pools(rng, num_pages, hkv, ps,
                                                    d, qname)
    bt = _table(rng, b, maxp, num_pages)
    start = np.array([0, 3, ps + 1, ps * maxp + 9], np.int32)
    span = np.array([c, c - 3, 0, 5], np.int32)
    q = rng.standard_normal((b, hq, c, d)).astype(np.float32)
    kn = rng.standard_normal((b, hkv, c, d)).astype(np.float32)
    vn = rng.standard_normal((b, hkv, c, d)).astype(np.float32)
    J = lambda a: jnp.asarray(a)
    T = lambda a: torch.from_numpy(np.array(a))
    want = jops.paged_chunk_attention_quant(
        J(q), jk, jks, jv, jvs, J(bt), J(start), J(span), J(kn), J(vn),
        window=window, use_pallas=False)
    got = tops.paged_chunk_attention_quant(
        T(q), tk, tks, tv, tvs, T(bt), T(start), T(span), T(kn), T(vn),
        window=window)
    live = np.arange(c)[None, :] < span[:, None]
    np.testing.assert_allclose(got[0].numpy().transpose(0, 2, 1, 3)[live],
                               np.asarray(want[0]).transpose(0, 2, 1, 3)[live],
                               **OUT_TOL)
    for w, g in zip(want[1:], got[1:]):
        np.testing.assert_array_equal(_bits(g), _jbits(w))


# ---------------------------------------------------------------------------
# The model with kv_quant
# ---------------------------------------------------------------------------

B, MAX_LEN, PS = 3, 32, 8


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.reduced(jconfigs.get("olmo-1b"), d_model=64,
                            vocab=512).replace(num_layers=2)
    tcfg = tconfigs.reduced(tconfigs.get("olmo-1b"), d_model=64,
                            vocab=512).replace(num_layers=2)
    jp = jlm.init(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    jmixed = jax.jit(lambda p, t, c, s, n: jlm.mixed_step(p, jcfg, t, c, s,
                                                          n))
    return jcfg, jp, tcfg, tp, jmixed


def _logits_close(want, got):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * LOGIT_TOL["atol"]
    np.testing.assert_array_equal(np.argmax(got, -1)[clear],
                                  np.argmax(want, -1)[clear])


def _quant_pools_close(jcache, tcache, tcfg, qname):
    want = convert.cache_from_jax(jax.tree.map(np.asarray, jcache), tcfg,
                                  device="cpu")
    for lw, lt in zip(want["layers"], tcache["layers"]):
        assert lw.keys() == lt.keys()
        np.testing.assert_array_equal(lt["block_tables"].numpy(),
                                      lw["block_tables"].numpy())
        for name in ("k", "v"):
            pw, pt = lw[f"{name}_pages"], lt[f"{name}_pages"]
            assert pw.dtype == pt.dtype == QDTYPES[qname][1]
            sw, st = lw[f"{name}_scales"], lt[f"{name}_scales"]
            dw = tref.dequantize_rows(pw, sw).numpy()
            dt = tref.dequantize_rows(pt, st).numpy()
            scale = np.maximum(sw.numpy(), st.numpy())[..., None]
            if qname == "int8":
                quantum = scale
            else:                       # one e4m3 step at the element
                mag = np.maximum(np.abs(dw), np.abs(dt)) / scale
                quantum = scale * np.exp2(np.floor(np.log2(
                    np.maximum(mag, 2.0 ** -6))) - 3)
            err = np.abs(dt - dw)
            tol = CACHE_TOL["atol"] + CACHE_TOL["rtol"] * np.abs(dw)
            assert (err <= np.maximum(tol, 2 * quantum)).all(), name
            share = float((err > quantum * (1 + 1e-6)).mean())
            assert share <= QUANTUM_SHARE, (name, share)


@pytest.mark.parametrize("chunk", [1, PS // 2, PS, 2 * PS])
@pytest.mark.parametrize("qname", sorted(QDTYPES))
def test_model_with_kv_quant_matches_jax(model, qname, chunk):
    """Chunked admission (mixed steps → paged_chunk_attention_quant), then
    two teacher-forced decode steps (paged_decode_attention_quant)."""
    jcfg, jp, tcfg, tp, jmixed = model
    jc = jlm.init_cache(jcfg, B, MAX_LEN, paged=True, page_size=PS,
                        kv_quant=qname)
    tc = tlm.init_cache(tcfg, B, MAX_LEN, paged=True, page_size=PS,
                        kv_quant=qname, device="cpu")
    jc = jlm.set_block_tables(jc, jattn.default_block_tables(B, MAX_LEN, PS))
    tc = tlm.set_block_tables(tc, tattn.default_block_tables(B, MAX_LEN, PS,
                                                             "cpu"))
    rng = np.random.default_rng(2)
    lengths = np.asarray([20, 3, 11], np.int32)
    prompts = rng.integers(0, 512, (B, 20)).astype(np.int32)
    filled = np.zeros(B, np.int32)
    while (filled < lengths).any():
        span = np.minimum(chunk, lengths - filled).clip(0).astype(np.int32)
        toks = np.zeros((B, chunk), np.int32)
        for b in range(B):
            toks[b, :span[b]] = prompts[b, filled[b]:filled[b] + span[b]]
        want, jc = jmixed(jp, jnp.asarray(toks), jc, jnp.asarray(filled),
                          jnp.asarray(span))
        got, tc = tlm.mixed_step(tp, tcfg, torch.from_numpy(toks), tc,
                                 torch.from_numpy(filled),
                                 torch.from_numpy(span))
        live = span > 0
        _logits_close(np.asarray(want, np.float32)[live],
                      convert.to_numpy(got)[live])
        filled = filled + span
    _quant_pools_close(jc, tc, tcfg, qname)
    pos = lengths.copy()
    for _ in range(2):
        tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
        want, jc = jlm.decode_step(jp, jcfg, jnp.asarray(tok), jc,
                                   jnp.asarray(pos))
        got, tc = tlm.decode_step(tp, tcfg, torch.from_numpy(tok), tc,
                                  torch.from_numpy(pos))
        _logits_close(want, convert.to_numpy(got))
        pos = pos + 1
    _quant_pools_close(jc, tc, tcfg, qname)


@pytest.mark.parametrize("qname", sorted(QDTYPES))
def test_quant_cache_layouts_match_jax(qname):
    jcfg = jconfigs.reduced(jconfigs.get("olmo-1b"), d_model=32, vocab=64)
    tcfg = tconfigs.reduced(tconfigs.get("olmo-1b"), d_model=32, vocab=64)
    jc = jlm.init_cache(jcfg, 2, 16, paged=True, page_size=8, num_pages=5,
                        kv_quant=qname)
    tc = tlm.init_cache(tcfg, 2, 16, paged=True, page_size=8, num_pages=5,
                        kv_quant=qname, device="cpu")
    want = convert.cache_from_jax(jax.tree.map(np.asarray, jc), tcfg,
                                  device="cpu")
    from repro_torch.models import cache as tcache
    for lw, lt in zip(want["layers"], tc["layers"]):
        assert tcache.layout_of(lt) == ("paged_mha_q8" if qname == "int8"
                                        else "paged_mha_fp8")
        for name in lw:
            assert lw[name].dtype == lt[name].dtype, name
            np.testing.assert_array_equal(_bits(lt[name]), _bits(lw[name]))
    src, dst = np.asarray([0, 3], np.int32), np.asarray([4, -1], np.int32)
    tc["layers"][0]["k_scales"][0] = 2.5
    tlm.copy_pages(tc, torch.from_numpy(src), torch.from_numpy(dst))
    assert bool((tc["layers"][0]["k_scales"][4] == 2.5).all())


@pytest.mark.parametrize("qname", sorted(QDTYPES))
def test_scheduler_with_kv_quant_matches_jax_counters(qname):
    jcfg = jconfigs.reduced(jconfigs.get("olmo-1b"), d_model=32, vocab=128)
    tcfg = tconfigs.reduced(tconfigs.get("olmo-1b"), d_model=32, vocab=128)
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      jlm.init(jax.random.PRNGKey(0), jcfg))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(1, 128, n)]
               for n in (9, 3, 14, 6, 11)]
    kw = dict(batch=3, max_len=32, page_size=4, num_pages=18, chunk_size=4,
              kv_quant=qname)
    jeng = jsched.ContinuousBatchingEngine(jcfg, jp, **kw)
    teng = tsched.ContinuousBatchingEngine(tcfg, tp, device="cpu", **kw)
    jreqs = [jsched.Request(i, p, 6) for i, p in enumerate(prompts)]
    treqs = [tsched.Request(i, p, 6) for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    teng.run(treqs)
    for name in ("steps", "prefill_chunks", "admitted", "completed",
                 "gen_tokens", "peak_pages", "grown_pages", "preemptions",
                 "prefill_tokens"):
        assert teng.stats[name] == jeng.stats[name], name
    assert tlm.get_block_tables(teng.cache).shape == (3, 8)
    assert teng.cache["layers"][0]["k_pages"].dtype == QDTYPES[qname][1]
    same = sum(a.tokens == b.tokens for a, b in zip(jreqs, treqs))
    assert same >= 3, [(a.tokens, b.tokens) for a, b in zip(jreqs, treqs)]
