"""The port's OLMo model against the JAX package, on the CPU.

Reduced ``olmo-1b`` (d_model 64, vocab 512, 2 layers — the agents' sim-LLM
shape), JAX ``lm.init`` weights carried across by ``params_from_jax``.
``forward``, ``prefill`` (uniform and ragged), ``decode_step`` and chunked
admission through ``mixed_step`` (chunk 1, ps/2, ps, 2·ps) are compared on
dense and paged caches.

Tolerances:
  * float32 weights and caches: 1e-4 — the same math, summed in another
    order by XLA and by PyTorch;
  * bfloat16 (the served dtype): logits within 0.1 + 0.05·|x| and cache
    leaves within 0.0625 + 0.05·|x|.  The two frameworks round bf16
    matmul and activation outputs at different places (one bf16 ulp is
    2^-8 relative, ~0.016 at |x| = 4), and the residual stream carries
    those differences through the layers.
Greedy tokens must agree wherever JAX's top-1/top-2 logit gap exceeds
twice the absolute tolerance (the sim-LLM has near-ties).  Bitwise
equality across chunkings is not asserted: the JAX reference does not
hold it on this build.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

B, MAX_LEN, PS = 3, 32, 8
LOGIT_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
             "bfloat16": dict(rtol=0.05, atol=0.1)}
CACHE_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
             "bfloat16": dict(rtol=0.05, atol=0.0625)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def jmixed(models):
    """JAX's mixed step, jitted (eager op-by-op dispatch is slow)."""
    jcfg = models["float32"][0]
    return jax.jit(lambda p, t, c, s, n: jlm.mixed_step(p, jcfg, t, c, s, n))


@pytest.fixture(scope="module")
def models():
    jcfg = jconfigs.reduced(jconfigs.get("olmo-1b"), d_model=64,
                            vocab=512).replace(num_layers=2)
    tcfg = tconfigs.reduced(tconfigs.get("olmo-1b"), d_model=64,
                            vocab=512).replace(num_layers=2)
    jp = jlm.init(jax.random.PRNGKey(0), jcfg)
    out = {}
    for name, (jdt, _) in DTYPES.items():
        jpd = jax.tree.map(lambda x: x.astype(jdt), jp)
        tp = convert.params_from_jax(jax.tree.map(np.asarray, jpd), tcfg,
                                     device="cpu")
        out[name] = (jcfg, jpd, tcfg, tp)
    return out


def _logits_close(want, got, dtype):
    want = np.asarray(want, np.float32)
    got = convert.to_numpy(got)
    tol = LOGIT_TOL[dtype]
    np.testing.assert_allclose(got, want, **tol)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * tol["atol"]
    np.testing.assert_array_equal(np.argmax(got, -1)[clear],
                                  np.argmax(want, -1)[clear])


def _caches_close(jcache, tcache, tcfg, dtype):
    want = convert.cache_from_jax(jax.tree.map(np.asarray, jcache), tcfg,
                                  device="cpu")
    for lw, lt in zip(want["layers"], tcache["layers"]):
        assert lw.keys() == lt.keys()
        for name in lw:
            np.testing.assert_allclose(convert.to_numpy(lt[name]),
                                       convert.to_numpy(lw[name]),
                                       **CACHE_TOL[dtype])


def _caches(jcfg, tcfg, dtype, paged):
    jdt, tdt = DTYPES[dtype]
    jc = jlm.init_cache(jcfg, B, MAX_LEN, dtype=jdt, paged=paged,
                        page_size=PS)
    tc = tlm.init_cache(tcfg, B, MAX_LEN, tdt, paged=paged, page_size=PS,
                        device="cpu")
    if paged:
        jc = jlm.set_block_tables(jc, jattn.default_block_tables(
            B, MAX_LEN, PS))
        tc = tlm.set_block_tables(tc, tattn.default_block_tables(
            B, MAX_LEN, PS))
    return jc, tc


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 512, (B, 12)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(models, dtype):
    jcfg, jp, tcfg, tp = models[dtype]
    toks = _prompts()
    want, _ = jlm.forward(jp, jcfg, jnp.asarray(toks))
    got, _ = tlm.forward(tp, tcfg, torch.from_numpy(toks))
    _logits_close(want, got, dtype)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_jax(models, dtype, paged, ragged):
    jcfg, jp, tcfg, tp = models[dtype]
    jc, tc = _caches(jcfg, tcfg, dtype, paged)
    toks = _prompts(1)
    lengths = np.asarray([12, 5, 8], np.int32) if ragged else None
    want, jc = jlm.prefill(jp, jcfg, jnp.asarray(toks), jc,
                           lengths=None if lengths is None
                           else jnp.asarray(lengths))
    got, tc = tlm.prefill(tp, tcfg, torch.from_numpy(toks), tc,
                          lengths=None if lengths is None
                          else torch.from_numpy(lengths))
    _logits_close(want, got, dtype)
    _caches_close(jc, tc, tcfg, dtype)
    pos = lengths.copy() if ragged else np.full((B,), 12, np.int32)
    for _ in range(3):                 # teacher-forced with JAX's tokens
        tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
        want, jc = jlm.decode_step(jp, jcfg, jnp.asarray(tok), jc,
                                   jnp.asarray(pos))
        got, tc = tlm.decode_step(tp, tcfg, torch.from_numpy(tok), tc,
                                  torch.from_numpy(pos))
        _logits_close(want, got, dtype)
        pos = pos + 1
    _caches_close(jc, tc, tcfg, dtype)


def _chunked_admit(step, cache, prompts, lengths, chunk, as_array):
    """Stream a ragged prompt batch in through mixed steps of ``chunk``
    (the loop of tests/test_mixed_step.py), for either package."""
    filled = np.zeros(len(lengths), np.int32)
    logits = None
    while (filled < lengths).any():
        span = np.minimum(chunk, lengths - filled).clip(0).astype(np.int32)
        toks = np.zeros((len(lengths), chunk), np.int32)
        for b in range(len(lengths)):
            toks[b, :span[b]] = prompts[b, filled[b]:filled[b] + span[b]]
        lg, cache = step(as_array(toks), cache, as_array(filled),
                         as_array(span))
        lg = np.asarray(lg, np.float32) if not isinstance(
            lg, torch.Tensor) else convert.to_numpy(lg)
        if logits is None:
            logits = lg.copy()
        else:
            logits[span > 0] = lg[span > 0]
        filled = filled + span
    return logits, cache


@pytest.mark.parametrize("chunk", [1, PS // 2, PS, 2 * PS])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_admission_matches_jax(models, jmixed, dtype, paged, chunk):
    jcfg, jp, tcfg, tp = models[dtype]
    jc, tc = _caches(jcfg, tcfg, dtype, paged)
    rng = np.random.default_rng(2)
    lengths = np.asarray([20, 3, 11], np.int32)
    prompts = rng.integers(0, 512, (B, 20)).astype(np.int32)
    want, jc = _chunked_admit(
        lambda t, c, s, n: jmixed(jp, t, c, s, n), jc,
        prompts, lengths, chunk, jnp.asarray)
    got, tc = _chunked_admit(
        lambda t, c, s, n: tlm.mixed_step(tp, tcfg, t, c, s, n), tc,
        prompts, lengths, chunk, torch.from_numpy)
    _logits_close(want, torch.from_numpy(got), dtype)
    _caches_close(jc, tc, tcfg, dtype)


def test_page_tables_and_copy_pages_match_jax(models):
    jcfg, jp, tcfg, tp = models["float32"]
    jc, tc = _caches(jcfg, tcfg, "float32", paged=True)
    toks = _prompts(3)
    _, jc = jlm.prefill(jp, jcfg, jnp.asarray(toks), jc)
    _, tc = tlm.prefill(tp, tcfg, torch.from_numpy(toks), tc)
    src = np.asarray([0, 5, -1, 2], np.int32)
    dst = np.asarray([7, 1, 3, -1], np.int32)
    jc = jlm.copy_pages(jc, jnp.asarray(src), jnp.asarray(dst))
    tc = tlm.copy_pages(tc, torch.from_numpy(src), torch.from_numpy(dst))
    _caches_close(jc, tc, tcfg, "float32")
    bt = np.arange(B * 4, dtype=np.int32)[::-1].reshape(B, 4).copy()
    jc = jlm.set_block_tables(jc, jnp.asarray(bt))
    tc = tlm.set_block_tables(tc, torch.from_numpy(bt))
    np.testing.assert_array_equal(tlm.get_block_tables(tc).numpy(),
                                  np.asarray(jlm.get_block_tables(jc)))
    with pytest.raises(ValueError, match="block table shape"):
        tlm.set_block_tables(tc, torch.zeros(B, 3, dtype=torch.int32))


@pytest.mark.parametrize("pattern", [("slstm",), ("mla_moe",), ("mlstm",)])
def test_unported_block_kinds_name_their_roadmap_item(pattern):
    """These kinds were the last unported ones and now run: ``init``
    gives every layer, and their caches equal JAX's.  The prefix-LM
    (``num_prefix_tokens``, PaliGemma's) now runs too: ``init`` of such a
    config works, and the mixed step and ragged prefill refuse it with
    JAX's messages, as JAX's do."""
    arch = "deepseek-v2-lite-16b" if pattern == ("mla_moe",) else "olmo-1b"
    jcfg, tcfg = (pkg.reduced(pkg.get(arch), d_model=32, vocab=64).replace(
        block_pattern=pattern) for pkg in (jconfigs, tconfigs))
    assert len(tlm.init(tcfg, device="cpu")["layers"]) == tcfg.num_layers
    want = convert.cache_from_jax(jax.tree.map(
        np.asarray, jlm.init_cache(jcfg, 1, 16)), tcfg, device="cpu")
    got = tlm.init_cache(tcfg, 1, 16, device="cpu")
    for lw, lt in zip(want["layers"], got["layers"]):
        assert lw.keys() == lt.keys()
        for name in lw:
            assert torch.equal(lw[name], lt[name]), name
    pcfg = tcfg.replace(num_prefix_tokens=8)
    assert len(tlm.init(pcfg, device="cpu")["layers"]) == pcfg.num_layers
    jpcfg = jcfg.replace(num_prefix_tokens=8)
    lengths = np.ones((1,), np.int32)
    for fn, cfg in ((jlm.mixed_step, jpcfg), (tlm.mixed_step, pcfg)):
        with pytest.raises(NotImplementedError,
                           match="without prefix or encoder inputs"):
            fn(None, cfg, None, None, None, None)
    for fn, cfg, ln in ((jlm.prefill, jpcfg, jnp.asarray(lengths)),
                        (tlm.prefill, pcfg, torch.from_numpy(lengths))):
        with pytest.raises(NotImplementedError, match="ragged prefill"):
            fn(None, cfg, None, None, lengths=ln)
