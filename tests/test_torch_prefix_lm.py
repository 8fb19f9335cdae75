"""The prefix-LM (PaliGemma) and the blockwise prefill against the JAX
package, on the CPU.

* ``common.make_mask`` with a bidirectional prefix: bitwise, over (tq, tk,
  window, prefix).
* ``attention._sdpa_chunked`` (the online-softmax loop over KV chunks)
  against JAX's at a small chunk: causal, windowed, with a prefix, GQA and
  MLA's Dv != D; float32 within 1e-5 (the same math, another summation
  order).
* The reduced ``paligemma-3b`` (8 prefix tokens, head_dim 16 on one KV
  head): ``forward``, then ``prefill`` + decode steps on dense and paged
  caches, and ``Engine.generate`` with ``prefix_embeds``, against JAX's;
  float32 logits and caches within 1e-4, greedy tokens where JAX's
  top-1/top-2 gap exceeds twice that.  The mixed step and ragged prefill
  refuse a prefix-LM, as JAX's do.
* A model-level prefill past ``lm.CHUNKED_THRESHOLD`` (patched small in
  both packages, in the test only) through the blockwise path: logits and
  caches within 1e-4 of JAX's, for the prefix-LM, OLMo and MLA.
* The plain ``paged_decode_attention`` at PaliGemma's head_dim 256, group
  8, against JAX's ``ref.py``: float32 within 1e-5, pools bitwise.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
B, PROMPT, MAX_LEN, PS, STEPS = 2, 6, 32, 8, 4


@pytest.mark.parametrize("tq,tk,window,prefix", [
    (12, 12, None, 0), (12, 12, None, 5), (12, 12, 3, 5), (7, 12, 4, 6),
    (12, 12, 2, 12), (1, 9, None, 4)])
def test_make_mask_with_prefix_matches_jax(tq, tk, window, prefix):
    want = np.asarray(jcommon.make_mask(tq, tk, causal=True, window=window,
                                        prefix_len=prefix))
    got = tcommon.make_mask(tq, tk, causal=True, window=window,
                            prefix_len=prefix).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hq,hkv,d,dv,tq,tk,causal,window,prefix", [
    (4, 2, 16, 16, 21, 21, True, None, 0),       # causal, GQA
    (4, 4, 16, 16, 21, 21, True, 5, 0),          # windowed
    (2, 1, 16, 16, 21, 21, True, 4, 7),          # prefix beats the window
    (4, 4, 24, 16, 13, 21, True, None, 3),       # MLA: Dv != D, Tq < Tk
    (2, 2, 16, 16, 21, 21, False, None, 0),      # bidirectional
])
def test_sdpa_chunked_matches_jax(hq, hkv, d, dv, tq, tk, causal, window,
                                  prefix):
    r = np.random.default_rng(0)
    q = r.normal(size=(2, hq, tq, d)).astype(np.float32)
    k = r.normal(size=(2, hkv, tk, d)).astype(np.float32)
    v = r.normal(size=(2, hkv, tk, dv)).astype(np.float32)
    kw = dict(causal=causal, window=window, prefix_len=prefix, chunk=8)
    want = np.asarray(jattn._sdpa_chunked(q, k, v, 0.25, **kw))
    got = tattn._sdpa_chunked(*map(torch.from_numpy, (q, k, v)), 0.25, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # One chunk holding every key: the same function.
    kw["chunk"] = 64
    np.testing.assert_allclose(
        tattn._sdpa_chunked(*map(torch.from_numpy, (q, k, v)), 0.25,
                            **kw).numpy(), want, rtol=1e-5, atol=1e-5)


def _models(arch):
    jcfg = jconfigs.reduced(jconfigs.get(arch), d_model=64, vocab=128)
    tcfg = tconfigs.reduced(tconfigs.get(arch), d_model=64, vocab=128)
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      jlm.init(jax.random.PRNGKey(0), jcfg))
    return jcfg, jp, tcfg, convert.params_from_jax(
        jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@pytest.fixture(scope="module")
def vlm():
    return _models("paligemma-3b")


def _inputs(cfg, seed=0):
    r = np.random.default_rng(seed)
    toks = r.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    pre = r.normal(size=(B, cfg.num_prefix_tokens,
                         cfg.d_model)).astype(np.float32)
    return toks, pre


def _logits_close(want, got):
    want = np.asarray(want, np.float32)
    got = convert.to_numpy(got)
    np.testing.assert_allclose(got, want, **TOL)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * TOL["atol"]
    np.testing.assert_array_equal(np.argmax(got, -1)[clear],
                                  np.argmax(want, -1)[clear])


def _caches_close(jcache, tcache, tcfg):
    want = convert.cache_from_jax(jax.tree.map(np.asarray, jcache), tcfg,
                                  device="cpu")
    for lw, lt in zip(want["layers"], tcache["layers"]):
        assert lw.keys() == lt.keys()
        for name in lw:
            np.testing.assert_allclose(convert.to_numpy(lt[name]),
                                       convert.to_numpy(lw[name]), **TOL)


def _caches(jcfg, tcfg, paged, max_len=MAX_LEN):
    jc = jlm.init_cache(jcfg, B, max_len, dtype=jnp.float32, paged=paged,
                        page_size=PS)
    tc = tlm.init_cache(tcfg, B, max_len, torch.float32, paged=paged,
                        page_size=PS, device="cpu")
    if paged:
        jc = jlm.set_block_tables(jc, jattn.default_block_tables(
            B, max_len, PS))
        tc = tlm.set_block_tables(tc, tattn.default_block_tables(
            B, max_len, PS))
    return jc, tc


def test_paligemma_init_and_forward_match_jax(vlm):
    """``init`` of the prefix-LM runs, and ``forward`` with the stub patch
    embeddings covers prefix and text (logits [B, P + T, V]), as JAX's;
    without ``prefix_embeds`` both run the text alone."""
    jcfg, jp, tcfg, tp = vlm
    assert len(tlm.init(tcfg, device="cpu")["layers"]) == tcfg.num_layers
    toks, pre = _inputs(jcfg)
    want, _ = jlm.forward(jp, jcfg, jnp.asarray(toks),
                          prefix_embeds=jnp.asarray(pre))
    got, _ = tlm.forward(tp, tcfg, torch.from_numpy(toks),
                         prefix_embeds=torch.from_numpy(pre))
    assert got.shape == (B, tcfg.num_prefix_tokens + PROMPT,
                         tcfg.vocab_size)
    _logits_close(want, got)
    want, _ = jlm.forward(jp, jcfg, jnp.asarray(toks))
    _logits_close(want, tlm.forward(tp, tcfg, torch.from_numpy(toks))[0])


@pytest.mark.parametrize("paged", [False, True])
def test_paligemma_prefill_and_decode_match_jax(vlm, paged):
    """prefill with ``prefix_embeds`` fills [0, P + T); decode continues at
    P + T: logits and caches after prefill and after each step."""
    jcfg, jp, tcfg, tp = vlm
    toks, pre = _inputs(jcfg, 1)
    jc, tc = _caches(jcfg, tcfg, paged)
    want, jc = jax.jit(lambda p, t, c, e: jlm.prefill(
        p, jcfg, t, c, prefix_embeds=e))(jp, toks, jc, pre)
    got, tc = tlm.prefill(tp, tcfg, torch.from_numpy(toks), tc,
                          prefix_embeds=torch.from_numpy(pre))
    _logits_close(want, got)
    _caches_close(jc, tc, tcfg)
    jdec = jax.jit(lambda p, t, c, s: jlm.decode_step(p, jcfg, t, c, s))
    fill = PROMPT + tcfg.num_prefix_tokens
    tok = np.array(jnp.argmax(want, -1), np.int32)
    for i in range(STEPS):
        pos = np.full((B,), fill + i, np.int32)
        want, jc = jdec(jp, tok, jc, pos)
        got, tc = tlm.decode_step(tp, tcfg, torch.from_numpy(tok), tc,
                                  torch.from_numpy(pos))
        _logits_close(want, got)
        tok = np.array(jnp.argmax(want, -1), np.int32)
    _caches_close(jc, tc, tcfg)


@pytest.mark.parametrize("paged", [False, True])
def test_paligemma_engine_matches_jax(vlm, paged):
    """``Engine.generate(tokens, steps, prefix_embeds=...)``: the greedy
    streams equal JAX's (float32 weights), and both engines decode from
    P + ``num_prefix_tokens``."""
    jcfg, jp, tcfg, tp = vlm
    toks, pre = _inputs(jcfg, 2)
    jeng = jengine.Engine(jcfg, jp, batch=B, max_len=MAX_LEN, paged=paged,
                          page_size=PS)
    teng = tengine.Engine(tcfg, tp, batch=B, max_len=MAX_LEN, paged=paged,
                          page_size=PS, device="cpu")
    want = np.asarray(jeng.generate(jnp.asarray(toks), STEPS,
                                    prefix_embeds=jnp.asarray(pre)))
    got = teng.generate(torch.from_numpy(toks), STEPS,
                        prefix_embeds=torch.from_numpy(pre)).numpy()
    np.testing.assert_array_equal(got, want)
    fill = PROMPT + tcfg.num_prefix_tokens + STEPS - 1
    np.testing.assert_array_equal(teng.pos.numpy(), np.asarray(jeng.pos))
    assert teng._pos_ceiling == jeng._pos_ceiling == fill


def test_paligemma_mixed_step_and_ragged_prefill_refuse(vlm):
    """As JAX's: the mixed step (so the scheduler) and ragged prefill do
    not take a prefix-LM."""
    jcfg, jp, tcfg, tp = vlm
    toks, _ = _inputs(jcfg)
    z = np.zeros((B,), np.int32)
    jc, tc = _caches(jcfg, tcfg, paged=True)
    for fn, args in ((jlm.mixed_step, (jp, jcfg, jnp.asarray(toks), jc,
                                       jnp.asarray(z), jnp.asarray(z))),
                     (tlm.mixed_step, (tp, tcfg, torch.from_numpy(toks), tc,
                                       torch.from_numpy(z),
                                       torch.from_numpy(z)))):
        with pytest.raises(NotImplementedError,
                           match="without prefix or encoder inputs"):
            fn(*args)
    lengths = np.full((B,), PROMPT, np.int32)
    with pytest.raises(NotImplementedError, match="ragged prefill"):
        jlm.prefill(jp, jcfg, jnp.asarray(toks), jc,
                    lengths=jnp.asarray(lengths))
    with pytest.raises(NotImplementedError, match="ragged prefill"):
        tlm.prefill(tp, tcfg, torch.from_numpy(toks), tc,
                    lengths=torch.from_numpy(lengths))


@pytest.mark.parametrize("arch", ["paligemma-3b", "olmo-1b",
                                  "deepseek-v2-lite-16b"])
def test_prefill_past_the_threshold_runs_blockwise(monkeypatch, arch):
    """With ``CHUNKED_THRESHOLD`` patched to 8 in both packages, a
    14-token prompt (22 with the prefix-LM's 8 stub embeddings) prefills
    through the blockwise path instead of raising: logits and caches
    within 1e-4 of JAX's, and of the port's own masked path; a ragged
    prompt past the threshold still raises, as in JAX."""
    jcfg, jp, tcfg, tp = _models(arch)
    r = np.random.default_rng(3)
    toks = r.integers(0, 128, (B, 14)).astype(np.int32)
    pre = (r.normal(size=(B, tcfg.num_prefix_tokens, 64)).astype(np.float32)
           if tcfg.num_prefix_tokens else None)
    masked, _ = tlm.prefill(tp, tcfg, torch.from_numpy(toks),
                            _caches(jcfg, tcfg, False)[1],
                            prefix_embeds=pre)
    for mod in (jlm, tlm):
        monkeypatch.setattr(mod, "CHUNKED_THRESHOLD", 8)
    calls = []
    real = tattn._sdpa_chunked
    monkeypatch.setattr(tattn, "_sdpa_chunked",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jc, tc = _caches(jcfg, tcfg, False)
    want, jc = jlm.prefill(jp, jcfg, jnp.asarray(toks), jc,
                           prefix_embeds=None if pre is None
                           else jnp.asarray(pre))
    got, tc = tlm.prefill(tp, tcfg, torch.from_numpy(toks), tc,
                          prefix_embeds=pre)
    assert len(calls) == tcfg.num_layers
    _logits_close(want, got)
    _caches_close(jc, tc, tcfg)
    np.testing.assert_allclose(got.numpy(), masked.numpy(), **TOL)
    if not tcfg.num_prefix_tokens:
        with pytest.raises(NotImplementedError, match="threshold"):
            tlm.prefill(tp, tcfg, torch.from_numpy(toks),
                        _caches(jcfg, tcfg, False)[1],
                        lengths=torch.full((B,), 14, dtype=torch.int32))


@pytest.mark.parametrize("window", [None, 37])
def test_plain_paged_decode_at_head_dim_256_matches_jax(window):
    """PaliGemma's paged decode shape cut to 3 rows: q [3, 8, 256] on one
    KV head of 256, pools [·, 1, 16, 256], positions up to 319 and one
    past the table (the wrapper's clamp is not the plain version's)."""
    r = np.random.default_rng(4)
    b, hq, hkv, d, ps, maxp = 3, 8, 1, 256, 16, 20
    q = r.normal(size=(b, hq, d)).astype(np.float32)
    kp, vp = (r.normal(size=(b * maxp + 1, hkv, ps, d)).astype(np.float32)
              for _ in range(2))
    bt = r.permutation(b * maxp + 1)[:b * maxp].reshape(b, maxp)
    bt = bt.astype(np.int32)
    bt[1, -1] = -1
    pos = np.asarray([319, 0, 100], np.int32)
    kn, vn = (r.normal(size=(b, hkv, d)).astype(np.float32)
              for _ in range(2))
    want = jref.paged_decode_attention(
        *map(jnp.asarray, (q, kp, vp, bt, pos, kn, vn)), window=window)
    got = tref.paged_decode_attention(*map(torch.from_numpy,
                                           (q, kp, vp, bt, pos, kn, vn)),
                                      window=window)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
