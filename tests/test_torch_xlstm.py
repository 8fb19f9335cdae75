"""The port's xLSTM blocks and the reduced ``xlstm-125m`` against the JAX
package, on the CPU.

Cell level: ``slstm_forward`` / ``mlstm_forward`` (with and without a
state, and ragged over ``lengths``: rows of length 0 keep their state bit
for bit) and the decode steps, on float32 JAX weights, outputs and states
within 1e-4.  Model level: reduced ``xlstm-125m`` (sLSTM, mLSTM; d_model
64, 4 heads), float32 JAX ``lm.init`` weights through ``params_from_jax``:
forward, prefill then decode, chunked admission through ``mixed_step``
(states too), the state layouts and ``lm.state_layers`` with reset /
snapshot / restore of the rows bitwise against JAX's, and the scheduler's
streams and counters (paged: the swap tier stays off, as in JAX).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import cache as tcache  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
B, MAX_LEN = 3, 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(tree):
    return jax.tree.map(lambda a: convert.to_tensor(np.asarray(a),
                                                    device="cpu"), tree)


def _close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


CELLS = {"slstm": (jx.slstm_init, jx.slstm_state, jx.slstm_forward,
                   jx.slstm_decode, tx.slstm_forward, tx.slstm_decode),
         "mlstm": (jx.mlstm_init, jx.mlstm_state, jx.mlstm_forward,
                   jx.mlstm_decode, tx.mlstm_forward, tx.mlstm_decode)}


@pytest.fixture(scope="module")
def cfgs():
    return [pkg.reduced(pkg.get("xlstm-125m")) for pkg in (jconfigs,
                                                          tconfigs)]


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_forward_and_decode_match_jax(cfgs, cell, ragged):
    """A forward from a warmed state (ragged: lengths 7, 0, 3, rows of 0
    untouched bitwise), then three decode steps; and a forward without a
    state (returns none)."""
    jcfg, tcfg = cfgs
    jinit, jstate, jfwd, jdec, tfwd, tdec = CELLS[cell]
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jinit(jax.random.PRNGKey(1), jcfg))
    tp = _t(jp)
    rng = np.random.default_rng(2)
    warm = rng.standard_normal((B, 5, jcfg.d_model)).astype(np.float32)
    _, js = jfwd(jp, jcfg, jnp.asarray(warm), jstate(jcfg, B))
    ts = _t(js)
    x = rng.standard_normal((B, 7, jcfg.d_model)).astype(np.float32)
    lengths = np.asarray([7, 0, 3], np.int32) if ragged else None
    jy, js2 = jfwd(jp, jcfg, jnp.asarray(x), js,
                   lengths=None if lengths is None else jnp.asarray(lengths))
    ty, ts2 = tfwd(tp, tcfg, torch.from_numpy(x), ts,
                   lengths=None if lengths is None
                   else torch.from_numpy(lengths))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    _close(ts2, js2)
    if ragged:
        for k in ts:
            assert torch.equal(ts2[k][1], ts[k][1]), k
    for i in range(3):
        xi = x[:, i:i + 1]
        jy, js2 = jdec(jp, jcfg, jnp.asarray(xi), js2)
        ty, ts2 = tdec(tp, tcfg, torch.from_numpy(xi), ts2)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        _close(ts2, js2)
    jy, none = jfwd(jp, jcfg, jnp.asarray(x))
    ty, tnone = tfwd(tp, tcfg, torch.from_numpy(x))
    assert none is None and tnone is None
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


@pytest.fixture(scope="module")
def model(cfgs):
    jcfg, tcfg = cfgs
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jax.jit(
        jlm.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    return dict(jcfg=jcfg, jp=jp, tcfg=tcfg, tp=tp,
                mixed=jax.jit(lambda p, t, c, s, n: jlm.mixed_step(
                    p, jcfg, t, c, s, n)),
                decode=jax.jit(lambda p, t, c, n: jlm.decode_step(
                    p, jcfg, t, c, n)),
                prefill=jax.jit(lambda p, t, c: jlm.prefill(p, jcfg, t, c)))


def _caches_close(jc, tc, tcfg, tol=TOL):
    want = convert.cache_from_jax(jax.tree.map(np.asarray, jc), tcfg,
                                  device="cpu")
    for lw, lt in zip(want["layers"], tc["layers"]):
        assert lw.keys() == lt.keys()
        for name in lw:
            assert lw[name].dtype == lt[name].dtype, name
            np.testing.assert_allclose(lt[name].numpy(), lw[name].numpy(),
                                       err_msg=name, **tol)


def _logits_close(want, got):
    want = np.asarray(want, np.float32)
    got = got.numpy()
    np.testing.assert_allclose(got, want, **TOL)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * TOL["atol"]
    np.testing.assert_array_equal(np.argmax(got, -1)[clear],
                                  np.argmax(want, -1)[clear])


def test_state_layouts_match_jax(model):
    """Both kinds take the ``state`` layout (paged or not): leaves, dtypes
    and fills (m at -10) equal JAX's init; ``lm.state_layers`` names every
    layer."""
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    assert tlm.state_layers(tcfg) == [0, 1]
    for paged in (False, True):
        jc = jlm.init_cache(jcfg, B, MAX_LEN, paged=paged, page_size=8)
        tc = tlm.init_cache(tcfg, B, MAX_LEN, paged=paged, page_size=8,
                            device="cpu")
        want = convert.cache_from_jax(jax.tree.map(np.asarray, jc), tcfg,
                                      device="cpu")
        for lw, lt in zip(want["layers"], tc["layers"]):
            assert tcache.layout_of(lt) == "state"
            assert lw.keys() == lt.keys()
            for name in lw:
                assert torch.equal(lt[name], lw[name]), name
        assert bool((tc["layers"][0]["m"] == -10).all())
    specs = tlm.cache_specs(tcfg, B, MAX_LEN, paged=True)["layers"]
    assert [s.layout for s in specs] == ["state", "state"]


def test_forward_prefill_and_decode_match_jax(model):
    jcfg, jp, tcfg, tp = (model[k] for k in ("jcfg", "jp", "tcfg", "tp"))
    toks = np.random.default_rng(0).integers(0, 256, (B, 10)).astype(
        np.int32)
    want = jax.jit(lambda p, t: jlm.forward(p, jcfg, t)[0])(
        jp, jnp.asarray(toks))
    got, aux = tlm.forward(tp, tcfg, torch.from_numpy(toks))
    _logits_close(want, got)
    assert float(aux) == 0.0
    jc = jlm.init_cache(jcfg, B, MAX_LEN)
    tc = tlm.init_cache(tcfg, B, MAX_LEN, device="cpu")
    want, jc = model["prefill"](jp, jnp.asarray(toks), jc)
    got, tc = tlm.prefill(tp, tcfg, torch.from_numpy(toks), tc)
    _logits_close(want, got)
    pos = np.full(B, 10, np.int32)
    for _ in range(3):
        tok = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
        want, jc = model["decode"](jp, jnp.asarray(tok), jc,
                                   jnp.asarray(pos))
        got, tc = tlm.decode_step(tp, tcfg, torch.from_numpy(tok), tc,
                                  torch.from_numpy(pos))
        _logits_close(want, got)
        pos = pos + 1
    _caches_close(jc, tc, tcfg)


@pytest.mark.parametrize("chunk", [1, 4, 16])
def test_mixed_step_matches_jax(model, chunk):
    """A ragged prompt batch (20, 3, 11) through mixed steps of ``chunk``:
    logits at the live rows and every state; span-0 rows keep theirs."""
    jcfg, jp, tcfg, tp = (model[k] for k in ("jcfg", "jp", "tcfg", "tp"))
    jc = jlm.init_cache(jcfg, B, MAX_LEN)
    tc = tlm.init_cache(tcfg, B, MAX_LEN, device="cpu")
    rng = np.random.default_rng(2)
    lengths = np.asarray([20, 3, 11], np.int32)
    prompts = rng.integers(0, 256, (B, 20)).astype(np.int32)
    filled = np.zeros(B, np.int32)
    while (filled < lengths).any():
        span = np.minimum(chunk, lengths - filled).clip(0).astype(np.int32)
        toks = np.zeros((B, chunk), np.int32)
        for b in range(B):
            toks[b, :span[b]] = prompts[b, filled[b]:filled[b] + span[b]]
        before = [{k: v.clone() for k, v in l.items()} for l in tc["layers"]]
        want, jc = model["mixed"](jp, jnp.asarray(toks), jc,
                                  jnp.asarray(filled), jnp.asarray(span))
        got, tc = tlm.mixed_step(tp, tcfg, torch.from_numpy(toks), tc,
                                 torch.from_numpy(filled),
                                 torch.from_numpy(span))
        live = span > 0
        _logits_close(np.asarray(want, np.float32)[live], got[live])
        for lb, la in zip(before, tc["layers"]):
            for k in lb:
                assert torch.equal(la[k][~torch.from_numpy(live)],
                                   lb[k][~torch.from_numpy(live)]), k
        filled = filled + span
    _caches_close(jc, tc, tcfg)


def test_state_rows_match_jax(model):
    """reset / snapshot / restore of the rows, bitwise against JAX's on the
    same cache."""
    jcfg, jp, tcfg = model["jcfg"], model["jp"], model["tcfg"]
    toks = np.random.default_rng(5).integers(0, 256, (B, 10)).astype(
        np.int32)
    _, jc = model["prefill"](jp, jnp.asarray(toks),
                             jlm.init_cache(jcfg, B, MAX_LEN))
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
            assert torch.equal(lt[name][1], lo[name][1]), name
        assert bool((lt["m"][0] == -10).all())
    jb = jax.jit(lambda c, n, m: jlm.restore_state_rows(jcfg, c, n, m))(
        jr, jsnap, jnp.asarray(mask))
    tb = tlm.restore_state_rows(tcfg, tr, tsnap, torch.from_numpy(mask))
    want = convert.cache_from_jax(jax.tree.map(np.asarray, jb), tcfg,
                                  device="cpu")
    for i, (lw, lt) in enumerate(zip(want["layers"], tb["layers"])):
        for name in lw:
            assert torch.equal(lt[name], lw[name]), (i, name)
            assert torch.equal(lt[name], tc["layers"][i][name])


COUNTERS = ("steps", "prefill_chunks", "admitted", "completed", "gen_tokens",
            "peak_pages", "grown_pages", "preemptions", "prefill_tokens",
            "decode_stall_steps", "preempt_recompute", "preempt_swap",
            "swap_outs", "swap_ins")


@pytest.mark.parametrize("paged", [False, True])
def test_scheduler_streams_and_counters_match_jax(model, paged):
    """Requests past the pool (paged: growth preempts and the victim
    recomputes, its row reset) with a swap tier asked for: a state model
    has none, in JAX and the port."""
    jcfg, jp, tcfg, tp = (model[k] for k in ("jcfg", "jp", "tcfg", "tp"))
    kw = dict(batch=2, max_len=32, paged=paged, page_size=8, chunk_size=4)
    if paged:
        kw.update(num_pages=4, swap_tier_pages=8)
    spec = [(10, 12), (9, 12), (5, 4)]
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(2, 200, n)] for n, _ in spec]
    jeng = jsched.ContinuousBatchingEngine(jcfg, jp, **kw)
    want = jeng.run([jsched.Request(i, list(p), m)
                     for i, (p, (_, m)) in enumerate(zip(prompts, spec))])
    teng = tsched.ContinuousBatchingEngine(tcfg, tp, device="cpu", **kw)
    got = teng.run([tsched.Request(i, list(p), m)
                    for i, (p, (_, m)) in enumerate(zip(prompts, spec))])
    for w, g in zip(want, got):
        assert g.tokens == w.tokens, g.rid
    for name in COUNTERS:
        assert teng.stats[name] == jeng.stats[name], name
    assert teng.swap_pool is None and jeng.swap_pool is None
    if paged:
        assert teng.stats["preempt_recompute"] > 0
        assert teng.allocator.available == jeng.allocator.available
