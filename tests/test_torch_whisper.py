"""The port's whisper encoder-decoder against the JAX package, on the CPU.

Kernel level: ``ref.flash_attention`` against JAX's ``ref.flash_attention``
and against JAX's Pallas kernel as JAX's own test runs it
(``ops.flash_attention`` in interpret mode, blocks of 128), on JAX's
``ATTN_CASES`` (tests/test_kernels.py) in float32 and bf16, plus a case
whose first query rows have no live key (causal with Tq > Tk): those rows
are NaN in both oracles (a softmax over nothing) and garbage in the Pallas
kernel, so only rows with a live key are compared; the CUDA kernel's 0 for
them is checked on the card (tests/test_torch_cuda.py).  Tolerances: the
port's plain version against JAX's oracle 1e-5 (float32) and 1e-2 + 1e-2·|x|
(bf16, PERF.md's policy: the frameworks' float32 sums differ in their last
bits before one bf16 rounding); against the Pallas kernel JAX's own
tolerance for it, 2e-5 and 2e-2 + 2e-2·|x|.

Module level: layernorm with scale and bias, dense layers with bias and the
``gelu_mlp`` FFN (whisper's, run on no other ported model) against JAX's
``common.apply_norm``, ``common.dense`` and ``ffn.forward``: 1e-6 (float32)
and one bf16 step (2^-7·|x| + 1e-6).

Model level: reduced ``whisper-tiny`` (2 decoder layers, d_model 64, 4
heads of 16, a 2-layer encoder over 16 stub frames), JAX ``lm.init``
weights carried across by ``params_from_jax`` (the stacked encoder blocks
included), in float32 and in the native bf16 with bf16 frames: ``_encode``,
``forward``, ``prefill`` + 3 ``decode_step``s (caches k, v, xk, xv) and
``Engine.generate`` with ``enc_frames``, each through both port routes:
``impl="kernel"`` (on the CPU the plain flash version: float32
probabilities) and ``impl="ref"`` (probabilities cast to the query's dtype,
as JAX's ``_sdpa``).  JAX runs ``impl="ref"``: its Pallas route makes the
encoder causal (ROADMAP.md queue 3), the port's encoder is bidirectional.
Tolerances as tests/test_torch_model.py: logits and hidden states 1e-4
(float32) and 0.1 + 0.05·|x| (bf16); caches 1e-4 and 0.0625 + 0.05·|x|;
greedy tokens equal wherever JAX's top-1/top-2 gap exceeds twice the logit
tolerance.
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
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import cache as jcache  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import ffn as jffn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import cache as tcache  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import ffn as tffn  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402

B, PROMPT, EXTRA = 3, 8, 3
MAX_LEN = PROMPT + EXTRA + 2
LOGIT_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
             "bfloat16": dict(rtol=0.05, atol=0.1)}
CACHE_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
             "bfloat16": dict(rtol=0.05, atol=0.0625)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ROUTES = ("kernel", "ref")


def _t(a) -> torch.Tensor:
    return convert.to_tensor(np.asarray(a), device="cpu")


def _f32(a) -> np.ndarray:
    return (convert.to_numpy(a) if isinstance(a, torch.Tensor)
            else np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

ATTN_CASES = [
    # (B, Hq, Hkv, Tq, Tk, D, causal, window): JAX's ATTN_CASES ...
    (1, 1, 1, 128, 128, 64, True, None),
    (2, 4, 2, 96, 96, 32, True, None),
    (1, 8, 1, 256, 256, 128, True, None),
    (1, 4, 4, 64, 192, 64, True, None),
    (2, 2, 2, 160, 160, 80, False, None),
    (1, 4, 2, 256, 256, 64, True, 64),
    # ... and query rows with no live key: causal, Tq > Tk.
    (2, 4, 2, 40, 24, 16, True, None),
]


def _attn_inputs(case, jdt, seed):
    b, hq, hkv, tq, tk, d = case[:6]
    rng = np.random.default_rng(seed)
    return tuple(np.asarray(jnp.asarray(rng.normal(size=s), jdt))
                 for s in ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d)))


def _live_rows(case) -> np.ndarray:
    """bool[Tq]: query rows with at least one live key."""
    _, _, _, tq, tk, _, causal, window = case
    qi = np.arange(tq)[:, None] + (tk - tq)
    ki = np.arange(tk)[None, :]
    live = np.ones((tq, tk), bool)
    if causal:
        live &= ki <= qi
    if window is not None:
        live &= ki >= qi - window + 1
    return live.any(axis=1)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_ref_matches_jax_ref(case, dtype):
    """The port's plain version against JAX's oracle; rows with no live key
    are NaN in both."""
    causal, window = case[6], case[7]
    q, k, v = _attn_inputs(case, DTYPES[dtype][0], 0)
    want = _f32(jax.jit(lambda *x: jref.flash_attention(
        *x, causal=causal, window=window))(q, k, v))
    got = tops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                               window=window)
    assert got.dtype == DTYPES[dtype][1] and got.shape == q.shape
    got = _f32(got)
    live = _live_rows(case)
    assert np.isnan(want[:, :, ~live]).all() and np.isnan(
        got[:, :, ~live]).all()
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=1e-2, atol=1e-2))
    np.testing.assert_allclose(got[:, :, live], want[:, :, live], **tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_ref_matches_jax_pallas_interpret(case, dtype):
    """JAX's Pallas kernel in interpret mode (Tq, Tk padded to its blocks,
    D to 128), as tests/test_kernels.py runs it, on the rows with a live
    key."""
    causal, window = case[6], case[7]
    q, k, v = _attn_inputs(case, DTYPES[dtype][0], 1)
    want = _f32(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, block_q=128, block_k=128))
    got = _f32(tref.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                    window=window))
    live = _live_rows(case)
    tol = (dict(rtol=2e-5, atol=2e-5) if dtype == "float32"
           else dict(rtol=2e-2, atol=2e-2))
    np.testing.assert_allclose(got[:, :, live], want[:, :, live], **tol)


def test_flash_scale_default_and_cpu_dispatch():
    """``scale`` defaults to D^-0.5, ``causal`` to True; a CPU tensor takes
    the plain version through the wrapper (no launch is counted)."""
    q, k, v = (_t(a) for a in _attn_inputs(ATTN_CASES[1], jnp.float32, 2))
    tops.reset_launch_counts()
    out = tops.flash_attention(q, k, v)
    assert tops.launch_counts()["flash_attention"] == 0
    torch.testing.assert_close(out, tref.flash_attention(
        q, k, v, causal=True, scale=q.shape[-1] ** -0.5), rtol=0, atol=0)
    with pytest.raises(ValueError, match="impl"):
        tops.flash_attention(q, k, v, impl="pallas")


# ---------------------------------------------------------------------------
# Whisper's module pieces: layernorm with bias, biased dense, gelu_mlp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_layernorm_dense_and_gelu_mlp_match_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    cfg = jconfigs.reduced(jconfigs.get("whisper-tiny"))
    rng = np.random.default_rng(3)
    d, f = cfg.d_model, cfg.d_ff

    def arr(*shape):
        return np.asarray(jnp.asarray(rng.normal(size=shape), jdt))

    x = arr(B, 5, d)
    norm = {"scale": arr(d), "bias": arr(d)}
    up, down = {"w": arr(d, f), "b": arr(f)}, {"w": arr(f, d), "b": arr(d)}
    to_t = lambda tree: {k: _t(a) for k, a in tree.items()}   # noqa: E731
    tol = (dict(rtol=1e-6, atol=1e-6) if dtype == "float32"
           else dict(rtol=2 ** -7, atol=1e-6))
    got = tcommon.apply_norm(to_t(norm), _t(x), "layernorm", cfg.norm_eps)
    want = jcommon.apply_norm(norm, x, "layernorm", cfg.norm_eps)
    assert got.dtype == tdt
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    jup = jax.tree.map(jnp.asarray, up)
    np.testing.assert_allclose(_f32(tcommon.dense(to_t(up), _t(x))),
                               _f32(jcommon.dense(jup, jnp.asarray(x))),
                               **tol)
    p = {"up": up, "down": down}
    got = tffn.forward({k: to_t(w) for k, w in p.items()}, cfg, _t(x))
    want = jax.jit(lambda p_, x_: jffn.forward(p_, cfg, x_))(p, x)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=0.05, atol=0.0625))
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


# ---------------------------------------------------------------------------
# The reduced whisper model
# ---------------------------------------------------------------------------

def test_whisper_config_is_jax_s():
    assert (dataclasses.asdict(tconfigs.get("whisper-tiny"))
            == dataclasses.asdict(jconfigs.get("whisper-tiny")))


@pytest.fixture(scope="module")
def models():
    """{dtype: (jcfg, jax params, tcfg, port params)}."""
    jcfg = jconfigs.reduced(jconfigs.get("whisper-tiny"), layers=2)
    tcfg = tconfigs.reduced(tconfigs.get("whisper-tiny"), layers=2)
    out = {}
    for dtype, (jdt, _) in DTYPES.items():
        jp = jlm.init(jax.random.PRNGKey(0), jcfg)
        if dtype == "float32":
            jp = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
        tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                     device="cpu")
        out[dtype] = (jcfg, jp, tcfg, tp)
    return out


def _inputs(cfg, dtype, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, PROMPT + EXTRA)).astype(
        np.int32)
    frames = np.asarray(jnp.asarray(
        rng.normal(size=(B, cfg.encoder.seq_len, cfg.d_model)),
        DTYPES[dtype][0]))
    return toks, frames


def _logits_close(want, got, dtype):
    want, got = _f32(want), _f32(got)
    tol = LOGIT_TOL[dtype]
    np.testing.assert_allclose(got, want, **tol)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * tol["atol"]
    np.testing.assert_array_equal(np.argmax(got, -1)[clear],
                                  np.argmax(want, -1)[clear])


@pytest.mark.parametrize("impl", ROUTES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_encode_matches_jax_and_is_bidirectional(models, dtype, impl):
    jcfg, jp, tcfg, tp = models[dtype]
    _, frames = _inputs(jcfg, dtype)
    want = jax.jit(lambda p, f: jlm._encode(p, jcfg, f, "ref"))(jp, frames)
    got = tlm._encode(tp, tcfg, _t(frames), impl)
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_f32(got), _f32(want), **LOGIT_TOL[dtype])
    # Bidirectional: the first frame's output moves with the last frame.
    later = frames.copy()
    later[:, -1] = -later[:, -1]
    moved = tlm._encode(tp, tcfg, _t(later), impl)
    assert not torch.equal(moved[:, 0], got[:, 0])


@pytest.mark.parametrize("impl", ROUTES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_forward_matches_jax(models, dtype, impl):
    jcfg, jp, tcfg, tp = models[dtype]
    toks, frames = _inputs(jcfg, dtype, 1)
    want, _ = jax.jit(lambda p, t, f: jlm.forward(p, jcfg, t, enc_frames=f))(
        jp, toks, frames)
    got, _ = tlm.forward(tp, tcfg, torch.from_numpy(toks),
                         enc_frames=_t(frames), impl=impl)
    assert got.shape == (B, PROMPT + EXTRA, tcfg.vocab_size)
    _logits_close(want, got, dtype)


def _caches_close(jc, tc, tcfg, dtype):
    want = convert.cache_from_jax(jax.tree.map(np.asarray, jc), tcfg,
                                  device="cpu")
    for lw, lt in zip(want["layers"], tc["layers"]):
        assert tcache.layout_of(lt) == "xattn"
        assert lw.keys() == lt.keys() == {"k", "v", "xk", "xv"}
        for name in lw:
            np.testing.assert_allclose(_f32(lt[name]), _f32(lw[name]),
                                       **CACHE_TOL[dtype])


@pytest.mark.parametrize("impl", ROUTES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_prefill_and_decode_match_jax(models, dtype, impl):
    """prefill (the encoder, the self-KV and the once-filled cross-KV),
    then 3 decode steps teacher-forced on the same tokens: logits of every
    step and the caches after prefill and after the last step."""
    jcfg, jp, tcfg, tp = models[dtype]
    jdt, tdt = DTYPES[dtype]
    toks, frames = _inputs(jcfg, dtype, 2)
    jpre = jax.jit(lambda p, t, c, f: jlm.prefill(p, jcfg, t, c,
                                                  enc_frames=f))
    jdec = jax.jit(lambda p, t, c, s: jlm.decode_step(p, jcfg, t, c, s))
    jc = jlm.init_cache(jcfg, B, MAX_LEN, dtype=jdt)
    tc = tlm.init_cache(tcfg, B, MAX_LEN, tdt, device="cpu")
    want, jc = jpre(jp, toks[:, :PROMPT], jc, frames)
    got, tc = tlm.prefill(tp, tcfg, torch.from_numpy(toks[:, :PROMPT]), tc,
                          impl=impl, enc_frames=_t(frames))
    _logits_close(want, got, dtype)
    _caches_close(jc, tc, tcfg, dtype)
    pos = np.full((B,), PROMPT, np.int32)
    for i in range(EXTRA):
        tok = toks[:, PROMPT + i]
        want, jc = jdec(jp, tok, jc, pos)
        got, tc = tlm.decode_step(tp, tcfg, torch.from_numpy(tok), tc,
                                  torch.from_numpy(pos), impl=impl)
        _logits_close(want, got, dtype)
        pos = pos + 1
    _caches_close(jc, tc, tcfg, dtype)


@pytest.mark.parametrize("impl", ROUTES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_engine_generate_matches_jax(models, dtype, impl):
    """``Engine.generate(tokens, steps, enc_frames=...)``: the greedy
    streams agree up to the first step where JAX's top-1/top-2 gap is
    within twice the logit tolerance (a near-tie may flip either way)."""
    jcfg, jp, tcfg, tp = models[dtype]
    toks, frames = _inputs(jcfg, dtype, 3)
    prompt, steps = toks[:, :PROMPT], EXTRA + 1
    jeng = jengine.Engine(jcfg, jp, batch=B, max_len=MAX_LEN)
    want = np.asarray(jeng.generate(jnp.asarray(prompt), steps,
                                    enc_frames=jnp.asarray(frames)))
    teng = tengine.Engine(tcfg, tp, batch=B, max_len=MAX_LEN, impl=impl,
                          device="cpu")
    got = teng.generate(prompt, steps, enc_frames=_t(frames)).numpy()
    assert got.shape == want.shape == (B, steps)
    # JAX's logits along its own stream, to tell a near-tie from a fault.
    jc = jlm.init_cache(jcfg, B, MAX_LEN, dtype=DTYPES[dtype][0])
    logits, jc = jlm.prefill(jp, jcfg, jnp.asarray(prompt), jc,
                             enc_frames=jnp.asarray(frames))
    gaps = []
    for s in range(steps):
        top2 = np.sort(_f32(logits), axis=-1)[:, -2:]
        gaps.append(top2[:, 1] - top2[:, 0])
        if s + 1 < steps:
            logits, jc = jlm.decode_step(
                jp, jcfg, jnp.asarray(want[:, s]), jc,
                jnp.full((B,), PROMPT + s, jnp.int32))
    gaps = np.stack(gaps, axis=1)
    for b in range(B):
        diff = np.nonzero(got[b] != want[b])[0]
        if diff.size:
            assert gaps[b, diff[0]] <= 2 * LOGIT_TOL[dtype]["atol"], (
                b, diff[0], got[b], want[b])


def test_xattn_layout_matches_jax_spec():
    """The ``xattn`` layout: self-KV [B, Hkv, max_len, D] and cross-KV
    [B, Hkv, enc.seq_len, D] leaves of JAX's names, shapes and dtypes,
    paged or not; ``layout_of`` tells it by its leaf set."""
    jcfg = jconfigs.reduced(jconfigs.get("whisper-tiny"), layers=2)
    tcfg = tconfigs.reduced(tconfigs.get("whisper-tiny"), layers=2)
    for paged in (False, True):
        assert tcache.layout_for("xattn", tcfg, paged=paged) == "xattn"
        js = jcache.spec_for("xattn", jcfg, B, MAX_LEN, jnp.bfloat16,
                             paged=paged)
        ts = tcache.spec_for("xattn", tcfg, B, MAX_LEN, torch.bfloat16,
                             paged=paged)
        assert ts.layout == js.layout == "xattn"
        assert [(l.name, tuple(l.shape), str(l.dtype).removeprefix("torch."),
                 l.role) for l in ts.leaves] == [
            (l.name, tuple(l.shape), np.dtype(l.dtype).name, l.role)
            for l in js.leaves]
    cache = tlm.init_cache(tcfg, B, MAX_LEN, device="cpu", paged=True)
    assert [tcache.layout_of(lc) for lc in cache["layers"]] == ["xattn"] * 2
    assert tlm.get_block_tables(cache) is None
    assert tlm.state_layers(tcfg) == []


def test_encdec_refuses_mixed_step_scheduler_ragged_prefill_and_prefix_lm(
        models):
    """As in JAX: the mixed step (so the scheduler) and ragged prefill
    refuse encoder-decoder models, and prefix-LMs too: a prefix-LM's
    ``init`` runs, and its mixed step and ragged prefill raise."""
    from repro_torch.serving.scheduler import ContinuousBatchingEngine
    from repro_torch.serving.scheduler import Request
    jcfg, jp, tcfg, tp = models["float32"]
    toks, frames = _inputs(jcfg, "float32")
    start = np.zeros((B,), np.int32)
    span = np.ones((B,), np.int32)
    jc = jlm.init_cache(jcfg, B, MAX_LEN, paged=True, page_size=4)
    with pytest.raises(NotImplementedError, match="mixed step"):
        jlm.mixed_step(jp, jcfg, jnp.asarray(toks[:, :2]), jc,
                       jnp.asarray(start), jnp.asarray(span))
    tc = tlm.init_cache(tcfg, B, MAX_LEN, device="cpu")
    with pytest.raises(NotImplementedError, match="mixed step"):
        tlm.mixed_step(tp, tcfg, torch.from_numpy(toks[:, :2]), tc,
                       torch.from_numpy(start), torch.from_numpy(span))
    with pytest.raises(NotImplementedError, match="mixed step"):
        eng = ContinuousBatchingEngine(tcfg, tp, batch=B, max_len=MAX_LEN,
                                       page_size=4, chunk_size=4,
                                       device="cpu")
        eng.run([Request(0, toks[0, :PROMPT].tolist(), 2)])
    lengths = np.full((B,), PROMPT, np.int32)
    with pytest.raises(NotImplementedError, match="ragged prefill"):
        jlm.prefill(jp, jcfg, jnp.asarray(toks[:, :PROMPT]),
                    jlm.init_cache(jcfg, B, MAX_LEN),
                    enc_frames=jnp.asarray(frames),
                    lengths=jnp.asarray(lengths))
    with pytest.raises(NotImplementedError, match="ragged prefill"):
        tlm.prefill(tp, tcfg, torch.from_numpy(toks[:, :PROMPT]), tc,
                    lengths=torch.from_numpy(lengths),
                    enc_frames=_t(frames))
    with pytest.raises(ValueError, match="enc_frames"):
        tlm.forward(tp, tcfg, torch.from_numpy(toks))
    vlm = tconfigs.reduced(tconfigs.get("olmo-1b"), d_model=32,
                           vocab=64).replace(num_prefix_tokens=8)
    vp = tlm.init(vlm, device="cpu")
    with pytest.raises(NotImplementedError,
                       match="without prefix or encoder inputs"):
        tlm.mixed_step(vp, vlm, torch.from_numpy(toks[:, :4]),
                       tlm.init_cache(vlm, B, MAX_LEN, device="cpu"),
                       torch.zeros(B, dtype=torch.int32),
                       torch.ones(B, dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="ragged prefill"):
        tlm.prefill(vp, vlm, torch.from_numpy(toks[:, :PROMPT]),
                    tlm.init_cache(vlm, B, MAX_LEN, device="cpu"),
                    lengths=torch.from_numpy(lengths))
