"""The port's MLA (latent attention) against the JAX package, on the CPU.

Kernel level: the four paged-MLA plain versions, through the ``ops``
wrappers, against JAX's oracles (``ops.*(use_pallas=False)``) on the sweeps
of tests/test_paged_mla.py (batch × page size × table length),
tests/test_mixed_step.py (chunk 1, 4, 8; float32 and bf16 pools) and
tests/test_quant_cache.py (int8, fp8): pools and scales bitwise, contexts
within 1e-5 at the defined queries (float32 throughout: a bf16 pool row
widens to float32 exactly, so only the summation order differs).  One case
whose tables hold no -1 also runs JAX's Pallas kernels in interpret mode.
The wrapper contracts (clamps, span clip, -1 drops, the width check) are
held to JAX's wrappers.

Model level: reduced ``deepseek-v2-lite-16b`` with dense FFNs
(``block_pattern=("mla",), moe=None``; 2 layers, d_model 32, r 32, rd 8),
JAX ``lm.init`` weights carried across by ``params_from_jax``: forward,
ragged prefill then decode, and chunked admission through ``mixed_step``
(chunk 1, ps/2, ps, 2·ps) on the dense, paged, int8 and fp8 latent
caches, float32 and bf16 weights.  Tolerances are those of
tests/test_torch_model.py (logits, float caches) and
tests/test_torch_quant.py (quantized pools, compared after
dequantization).
"""
from __future__ import annotations

import functools

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
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import cache as tcache  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
QDTYPES = {"int8": (jnp.int8, torch.int8),
           "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}
FDTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bits(t) -> np.ndarray:
    """Raw bytes of a tensor or JAX array (one-byte dtypes as uint8)."""
    if isinstance(t, torch.Tensor):
        if t.element_size() == 1:
            t = t.view(torch.uint8)
        elif t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    a = np.asarray(t)
    if a.dtype.itemsize == 1:
        return a.view(np.uint8)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _pair(a, jdt):
    """One numpy array as (jax array, torch tensor) with the same bits."""
    j = jnp.asarray(a, jdt)
    return j, convert.to_tensor(np.asarray(j), device="cpu")


def _table(rng, b, maxp, pool, minus_one=True):
    """Shuffled page ids (page 0 belongs to no row); the second half of
    row 0's table at -1 where asked (writes drop, reads see page 0)."""
    bt = (1 + rng.permutation(pool - 1)[:b * maxp]).reshape(b, maxp)
    bt = bt.astype(np.int32)
    if minus_one:
        bt[0, maxp // 2:] = -1
    return bt


def _latent_case(rng, b, h, c, r, rd, ps, maxp, pool_dtype, minus_one=True):
    """Queries, a latent pool (float, or quantized rows and scales), a table
    and new rows, each as a (jax, torch) pair."""
    dp = tcache.pad128(r + rd)
    pool = b * maxp + 2
    shape = (b, h, r) if c is None else (b, h, c, r)
    q_abs = _pair(rng.normal(size=shape), jnp.float32)
    q_rope = _pair(rng.normal(size=shape[:-1] + (rd,)), jnp.float32)
    rows = rng.normal(size=(pool, ps, dp))
    if pool_dtype in QDTYPES:
        lq, ls = jref.quantize_rows(jnp.asarray(rows, jnp.float32),
                                    QDTYPES[pool_dtype][0])
        lp = (lq, convert.to_tensor(np.asarray(lq), device="cpu"))
        scales = (ls, torch.from_numpy(np.array(ls)))
        new_dt = jnp.float32
    else:
        lp = _pair(rows, FDTYPES[pool_dtype][0])
        scales = None
        new_dt = FDTYPES[pool_dtype][0]
    bt = _table(rng, b, maxp, pool, minus_one)
    new = rng.normal(size=(b, dp) if c is None else (b, c, dp))
    return q_abs, q_rope, lp, scales, (jnp.asarray(bt), torch.from_numpy(bt)
                                       ), _pair(new, new_dt)


def _run(name, args, scale, use_pallas=False):
    """(JAX's ``ops.<name>``, the port's ``ops.<name>``) on the (jax,
    torch) pairs ``args``.  JAX's runs jitted: eager dispatch compiles op
    by op, which costs seconds a call."""
    jop = jax.jit(functools.partial(getattr(jops, name), scale=scale,
                                    use_pallas=use_pallas))
    return (jop(*(a[0] for a in args)),
            getattr(tops, name)(*(a[1] for a in args), scale=scale))


def _ints(a):
    a = np.asarray(a, np.int32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _check(want, got, live=None):
    """ctx within 1e-5 (at ``live`` queries), pools and scales bitwise."""
    w_ctx, g_ctx = np.asarray(want[0]), got[0].numpy()
    assert got[0].dtype == torch.float32
    if live is not None:                # [B, C] over ctx [B, H, C, r]
        w_ctx = w_ctx.transpose(0, 2, 1, 3)[live]
        g_ctx = g_ctx.transpose(0, 2, 1, 3)[live]
    np.testing.assert_allclose(g_ctx, w_ctx, **OUT_TOL)
    for w, g in zip(want[1:], got[1:]):
        np.testing.assert_array_equal(_bits(g), _bits(w))


# ---------------------------------------------------------------------------
# The four oracles against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,ps,maxp", [(1, 4, 3), (2, 8, 2), (3, 16, 4),
                                       (4, 8, 5)])
def test_paged_mla_decode_matches_jax(b, ps, maxp):
    """tests/test_paged_mla.py's sweep (h 4, r 32, rd 8), -1 entries and a
    position past the table (the clamp) added."""
    rng = np.random.default_rng(b * 10 + ps)
    q_abs, q_rope, lp, _, bt, new = _latent_case(rng, b, 4, None, 32, 8, ps,
                                                 maxp, "float32")
    pos = rng.integers(0, maxp * ps, b)
    pos[-1] = maxp * ps + 3
    pos = _ints(pos)
    want, got = _run("paged_mla_decode", (q_abs, q_rope, lp, bt, pos, new),
                     0.11)
    _check(want, got)


@pytest.mark.parametrize("c", [1, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_mla_chunk_matches_jax(c, dtype):
    """tests/test_mixed_step.py's sweep (h 4, r 16, rd 8, ps 8, maxp 4),
    with -1 entries, an idle row, and a start past the table."""
    rng = np.random.default_rng(7)
    b, ps, maxp = 3, 8, 4
    q_abs, q_rope, lp, _, bt, new = _latent_case(rng, b, 4, c, 16, 8, ps,
                                                 maxp, dtype)
    start = np.array([3, maxp * ps - c, maxp * ps + 5])
    span = np.array([c, 0, c])
    st, sp = _ints(start), _ints(span)
    want, got = _run("paged_mla_chunk", (q_abs, q_rope, lp, bt, st, sp, new),
                     0.125)
    _check(want, got, live=np.arange(c)[None, :] < span[:, None])


@pytest.mark.parametrize("qname", sorted(QDTYPES))
def test_paged_mla_decode_quant_matches_jax(qname):
    rng = np.random.default_rng(5)
    b, ps, maxp = 3, 8, 3
    q_abs, q_rope, lp, ls, bt, new = _latent_case(rng, b, 2, None, 16, 8,
                                                  ps, maxp, qname)
    pos = _ints([4, 12, maxp * ps + 1])
    want, got = _run("paged_mla_decode_quant",
                     (q_abs, q_rope, lp, ls, bt, pos, new), 0.2)
    _check(want, got)


@pytest.mark.parametrize("qname", sorted(QDTYPES))
def test_paged_mla_chunk_quant_matches_jax(qname):
    rng = np.random.default_rng(6)
    b, ps, maxp, c = 3, 8, 4, 8
    q_abs, q_rope, lp, ls, bt, new = _latent_case(rng, b, 2, c, 32, 8, ps,
                                                  maxp, qname)
    start, span = np.array([0, 13, maxp * ps + 2]), np.array([c, 3, 5])
    st, sp = _ints(start), _ints(span)
    want, got = _run("paged_mla_chunk_quant",
                     (q_abs, q_rope, lp, ls, bt, st, sp, new), 0.2)
    _check(want, got, live=np.arange(c)[None, :] < span[:, None])


@pytest.mark.parametrize("op", ["decode", "chunk", "decode_quant",
                                "chunk_quant"])
def test_paged_mla_matches_jax_pallas_interpret(op):
    """JAX's Pallas kernels (interpret mode) on tables without -1 entries:
    the port's plain versions equal them as they equal JAX's oracles."""
    rng = np.random.default_rng(8)
    b, ps, maxp, c = 2, 8, 3, 4
    quant = op.endswith("_quant")
    chunk = op.startswith("chunk")
    q_abs, q_rope, lp, ls, bt, new = _latent_case(
        rng, b, 4, c if chunk else None, 32, 8, ps, maxp,
        "int8" if quant else "float32", minus_one=False)
    idx = ((_ints([5, 9]), _ints([c, 2])) if chunk else (_ints([5, 17]),))
    pools = (lp, ls) if quant else (lp,)
    want, got = _run("paged_mla_" + op,
                     (q_abs, q_rope, *pools, bt, *idx, new), 0.15,
                     use_pallas=True)
    live = (np.arange(c)[None, :] < np.array([c, 2])[:, None]
            if chunk else None)
    _check(want, got, live=live)


def test_paged_mla_wrapper_contracts_match_jax():
    """A table of -1 drops every write (the pool is unchanged); positions
    past the table rewrite its last slot; spans past C clip to C and
    negative spans to 0; a pool narrower than r + rd raises."""
    rng = np.random.default_rng(9)
    b, ps, maxp, c = 2, 8, 2, 4
    q_abs, q_rope, lp, _, _, new = _latent_case(rng, b, 2, None, 16, 8, ps,
                                                maxp, "float32")
    none = _ints(np.full((b, maxp), -1))
    before = lp[1].clone()
    pos = _ints([3, 200])
    want, got = _run("paged_mla_decode", (q_abs, q_rope, lp, none, pos, new),
                     0.2)
    _check(want, got)
    assert torch.equal(got[1], before)
    q_abs, q_rope, lp, _, bt, new = _latent_case(rng, b, 2, c, 16, 8, ps,
                                                 maxp, "float32",
                                                 minus_one=False)
    st, sp = _ints([maxp * ps + 7, 1]), _ints([c + 5, -3])
    want, got = _run("paged_mla_chunk", (q_abs, q_rope, lp, bt, st, sp, new),
                     0.2)
    _check(want, got, live=np.array([[True] * c, [False] * c]))
    narrow = torch.zeros(4, ps, 16)
    ints = torch.zeros(b, dtype=torch.int32)
    scales = torch.ones(4, ps)
    calls = [
        lambda: tops.paged_mla_decode(q_abs[1][:, :, 0], q_rope[1][:, :, 0],
                                      narrow, bt[1], ints,
                                      new[1][:, 0, :16], scale=1.0),
        lambda: tops.paged_mla_chunk(q_abs[1], q_rope[1], narrow, bt[1],
                                     ints, ints, new[1][..., :16],
                                     scale=1.0),
        lambda: tops.paged_mla_decode_quant(
            q_abs[1][:, :, 0], q_rope[1][:, :, 0], narrow.to(torch.int8),
            scales, bt[1], ints, new[1][:, 0, :16], scale=1.0),
        lambda: tops.paged_mla_chunk_quant(
            q_abs[1], q_rope[1], narrow.to(torch.int8), scales, bt[1], ints,
            ints, new[1][..., :16], scale=1.0)]
    for call in calls:
        with pytest.raises(ValueError, match="latent pool width 16"):
            call()


# ---------------------------------------------------------------------------
# The model on the four latent caches
# ---------------------------------------------------------------------------

B, MAX_LEN, PS = 3, 32, 8
LAYOUTS = {"dense_mla": (False, "off"), "paged_mla": (True, "off"),
           "paged_mla_q8": (True, "int8"), "paged_mla_fp8": (True, "fp8")}
LOGIT_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
             "bfloat16": dict(rtol=0.05, atol=0.1)}
CACHE_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
             "bfloat16": dict(rtol=0.05, atol=0.0625)}
# Share of dequantized latent-pool elements allowed more than one quantum
# apart (tests/test_torch_quant.py's bound for the MHA pools).
QUANTUM_SHARE = 0.05


def _mla_cfg(pkg):
    return pkg.reduced(pkg.get("deepseek-v2-lite-16b"), layers=2,
                       d_model=32, vocab=128).replace(block_pattern=("mla",),
                                                      moe=None)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _mla_cfg(jconfigs), _mla_cfg(tconfigs)
    jp = jax.jit(jlm.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    out = {}
    for name, (jdt, _) in FDTYPES.items():
        jpd = jax.tree.map(lambda x: x.astype(jdt), jp)
        tp = convert.params_from_jax(jax.tree.map(np.asarray, jpd), tcfg,
                                     device="cpu")
        out[name] = (jcfg, jpd, tcfg, tp)
    out["jmixed"] = jax.jit(lambda p, t, c, s, n: jlm.mixed_step(
        p, jcfg, t, c, s, n))
    out["jdecode"] = jax.jit(lambda p, t, c, n: jlm.decode_step(
        p, jcfg, t, c, n))
    out["jprefill"] = jax.jit(lambda p, t, c, n: jlm.prefill(
        p, jcfg, t, c, lengths=n))
    out["jforward"] = jax.jit(lambda p, t: jlm.forward(p, jcfg, t)[0])
    return out


def _caches(jcfg, tcfg, dtype, layout):
    paged, quant = LAYOUTS[layout]
    jdt, tdt = FDTYPES[dtype]
    jc = jlm.init_cache(jcfg, B, MAX_LEN, dtype=jdt, paged=paged,
                        page_size=PS, kv_quant=quant)
    tc = tlm.init_cache(tcfg, B, MAX_LEN, tdt, paged=paged, page_size=PS,
                        kv_quant=quant, device="cpu")
    if paged:
        jc = jlm.set_block_tables(jc, jattn.default_block_tables(
            B, MAX_LEN, PS))
        tc = tlm.set_block_tables(tc, tattn.default_block_tables(
            B, MAX_LEN, PS))
    assert all(tcache.layout_of(l) == layout for l in tc["layers"])
    return jc, tc


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
    """Float leaves within CACHE_TOL; a quantized latent pool after
    dequantization, within CACHE_TOL or two quanta, at most QUANTUM_SHARE
    of its elements more than one quantum apart."""
    want = convert.cache_from_jax(jax.tree.map(np.asarray, jc), tcfg,
                                  device="cpu")
    for lw, lt in zip(want["layers"], tc["layers"]):
        assert lw.keys() == lt.keys()
        if "latent_scales" not in lw:
            for name in lw:
                assert lw[name].dtype == lt[name].dtype, name
                np.testing.assert_allclose(convert.to_numpy(lt[name]),
                                           convert.to_numpy(lw[name]),
                                           **CACHE_TOL[dtype])
            continue
        np.testing.assert_array_equal(lt["block_tables"].numpy(),
                                      lw["block_tables"].numpy())
        pw, pt = lw["latent_pages"], lt["latent_pages"]
        sw, st = lw["latent_scales"], lt["latent_scales"]
        assert pw.dtype == pt.dtype and sw.dtype == st.dtype == torch.float32
        dw = tref.dequantize_rows(pw, sw).numpy()
        dt = tref.dequantize_rows(pt, st).numpy()
        scale = np.maximum(sw.numpy(), st.numpy())[..., None]
        if pw.dtype == torch.int8:
            quantum = scale
        else:                           # one e4m3 step at the element
            mag = np.maximum(np.abs(dw), np.abs(dt)) / scale
            quantum = scale * np.exp2(np.floor(np.log2(
                np.maximum(mag, 2.0 ** -6))) - 3)
        err = np.abs(dt - dw)
        tol = CACHE_TOL[dtype]["atol"] + CACHE_TOL[dtype]["rtol"] * np.abs(dw)
        assert (err <= np.maximum(tol, 2 * quantum)).all()
        assert float((err > quantum * (1 + 1e-6)).mean()) <= QUANTUM_SHARE


@pytest.mark.parametrize("dtype", sorted(FDTYPES))
def test_mla_forward_matches_jax(models, dtype):
    jcfg, jp, tcfg, tp = models[dtype]
    toks = np.random.default_rng(0).integers(0, 128, (B, 12)).astype(
        np.int32)
    want = models["jforward"](jp, jnp.asarray(toks))
    got, _ = tlm.forward(tp, tcfg, torch.from_numpy(toks))
    _logits_close(want, got, dtype)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("dtype", sorted(FDTYPES))
def test_mla_prefill_then_decode_matches_jax(models, dtype, layout):
    """Ragged prefill (lengths 12, 5, 8), then three teacher-forced decode
    steps (paged: paged_mla_decode[_quant])."""
    jcfg, jp, tcfg, tp = models[dtype]
    jc, tc = _caches(jcfg, tcfg, dtype, layout)
    toks = np.random.default_rng(1).integers(0, 128, (B, 12)).astype(
        np.int32)
    lengths = np.asarray([12, 5, 8], np.int32)
    want, jc = models["jprefill"](jp, jnp.asarray(toks), jc,
                                  jnp.asarray(lengths))
    got, tc = tlm.prefill(tp, tcfg, torch.from_numpy(toks), tc,
                          lengths=torch.from_numpy(lengths))
    _logits_close(want, got, dtype)
    _caches_close(jc, tc, tcfg, dtype)
    pos = lengths.copy()
    for _ in range(3):
        tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
        want, jc = models["jdecode"](jp, jnp.asarray(tok), jc,
                                     jnp.asarray(pos))
        got, tc = tlm.decode_step(tp, tcfg, torch.from_numpy(tok), tc,
                                  torch.from_numpy(pos))
        _logits_close(want, got, dtype)
        pos = pos + 1
    _caches_close(jc, tc, tcfg, dtype)


@pytest.mark.parametrize("chunk", [1, PS // 2, PS, 2 * PS])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("dtype", sorted(FDTYPES))
def test_mla_chunked_admission_matches_jax(models, dtype, layout, chunk):
    """A ragged prompt batch (20, 3, 11 tokens) streamed in through mixed
    steps of ``chunk`` (paged: paged_mla_chunk[_quant])."""
    jcfg, jp, tcfg, tp = models[dtype]
    jc, tc = _caches(jcfg, tcfg, dtype, layout)
    rng = np.random.default_rng(2)
    lengths = np.asarray([20, 3, 11], np.int32)
    prompts = rng.integers(0, 128, (B, 20)).astype(np.int32)
    filled = np.zeros(B, np.int32)
    while (filled < lengths).any():
        span = np.minimum(chunk, lengths - filled).clip(0).astype(np.int32)
        toks = np.zeros((B, chunk), np.int32)
        for b in range(B):
            toks[b, :span[b]] = prompts[b, filled[b]:filled[b] + span[b]]
        want, jc = models["jmixed"](jp, jnp.asarray(toks), jc,
                                    jnp.asarray(filled), jnp.asarray(span))
        got, tc = tlm.mixed_step(tp, tcfg, torch.from_numpy(toks), tc,
                                 torch.from_numpy(filled),
                                 torch.from_numpy(span))
        live = span > 0
        _logits_close(np.asarray(want, np.float32)[live],
                      convert.to_numpy(got)[live], dtype)
        filled = filled + span
    _caches_close(jc, tc, tcfg, dtype)


@pytest.mark.parametrize("qname", sorted(QDTYPES))
def test_mla_cache_layouts_match_jax(qname):
    """The latent layouts' leaves (names, shapes, dtypes, fills) equal
    JAX's; page copies move scales with their pages; ``mla_moe`` takes
    the same layouts."""
    jcfg, tcfg = _mla_cfg(jconfigs), _mla_cfg(tconfigs)
    for paged, quant in ((False, "off"), (True, "off"), (True, qname)):
        jc = jlm.init_cache(jcfg, 2, 16, paged=paged, page_size=8,
                            num_pages=5, kv_quant=quant)
        tc = tlm.init_cache(tcfg, 2, 16, paged=paged, page_size=8,
                            num_pages=5, kv_quant=quant, device="cpu")
        want = convert.cache_from_jax(jax.tree.map(np.asarray, jc), tcfg,
                                      device="cpu")
        for lw, lt in zip(want["layers"], tc["layers"]):
            assert lw.keys() == lt.keys()
            for name in lw:
                assert lw[name].dtype == lt[name].dtype, name
                np.testing.assert_array_equal(_bits(lt[name]),
                                              _bits(lw[name]))
    layer = tmla.init_cache(tcfg, 2, 16, paged=True, page_size=8,
                            num_pages=5, kv_quant=qname, device="cpu")
    assert {k: (v.shape, v.dtype) for k, v in layer.items()} == {
        k: (v.shape, v.dtype) for k, v in tc["layers"][0].items()}
    spec = tlm.cache_specs(tcfg, 2, 16, paged=True, page_size=8,
                           kv_quant=qname)["layers"][0]
    assert spec.latent_width == 40
    assert spec.layout == ("paged_mla_q8" if qname == "int8"
                           else "paged_mla_fp8")
    tc["layers"][0]["latent_scales"][0] = 2.5
    tlm.copy_pages(tc, torch.tensor([0, 3]), torch.tensor([4, -1]))
    assert bool((tc["layers"][0]["latent_scales"][4] == 2.5).all())
    moe_cfg = tcfg.replace(block_pattern=("mla_moe",))
    for paged, quant in ((False, "off"), (True, "off"), (True, qname)):
        got, want = (tlm.cache_specs(c, 2, 16, paged=paged, page_size=8,
                                     num_pages=5, kv_quant=quant)
                     for c in (moe_cfg, tcfg))
        assert [(s.layout, s.leaves) for s in got["layers"]] == [
            (s.layout, s.leaves) for s in want["layers"]]
