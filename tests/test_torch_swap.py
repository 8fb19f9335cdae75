"""The port's swap tier against the JAX package, on the CPU.

The swap pool: ``make_swap_pool``'s leaves (the pools' and scales' shapes
with the page axis replaced by the slots, their dtypes) equal JAX's
unstacked; ``swap_out_pages`` moves JAX's byte count and leaves a mirror
bitwise equal to JAX's numpy pool; a swap-out / clobber / swap-in round
trip is bitwise on bf16, int8 and fp8 pools (tests/test_quant_cache.py's
case, scales included).  The scheduler: tests/test_quant_cache.py's
``SWAP_KW`` scenario (a 24-token and a 6-token prompt over 6 pages of 8,
16 new tokens each, reduced OLMo-1B, float32 weights) with the swap tier
off and on, on float32 and int8 pools: streams and the whole ``stats``
dict (but its host-time ``admit_s``) equal JAX's; swapping beats
recompute in steps; nothing leaks at drain; a model with recurrent
layers gets no swap pool.
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
from repro.models import cache as jcache  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import cache as tcache  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402

POOLS = {"bf16": (jnp.bfloat16, "off"), "int8": (jnp.float32, "int8"),
         "fp8": (jnp.float32, "fp8")}


@pytest.fixture(scope="module")
def llm():
    cfgs = [pkg.reduced(pkg.get("olmo-1b"), d_model=32, vocab=128)
            for pkg in (jconfigs, tconfigs)]
    jp = jax.tree.map(lambda x: x.astype(jnp.float32), jax.jit(
        jlm.init, static_argnums=1)(jax.random.PRNGKey(0), cfgs[0]))
    return cfgs[0], jp, cfgs[1], convert.params_from_jax(
        jax.tree.map(np.asarray, jp), cfgs[1], device="cpu")


def _bits(t) -> np.ndarray:
    """Raw bits of a tensor or array (bf16 as int16, one-byte as uint8)."""
    if isinstance(t, torch.Tensor):
        if t.element_size() == 1:
            return t.view(torch.uint8).numpy()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy()
    a = np.asarray(t)
    if a.dtype.itemsize == 1:
        return a.view(np.uint8)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _prefilled(llm, pool, batch=2, max_len=32, ps=8, plen=10):
    """JAX's prefilled paged cache (tests/test_quant_cache.py's
    ``_quant_prefilled``) and the port's bitwise copy of it."""
    jcfg, jp, tcfg, _ = llm
    dtype, quant = POOLS[pool]
    cache = jlm.init_cache(jcfg, batch, max_len, dtype=dtype, paged=True,
                           page_size=ps, kv_quant=quant)
    cache = jlm.set_block_tables(
        cache, jattn.default_block_tables(batch, max_len, ps))
    prompts = jnp.asarray(np.random.default_rng(0).integers(
        2, jcfg.vocab_size, (batch, plen)), jnp.int32)
    _, cache = jax.jit(lambda p, t, c: jlm.prefill(p, jcfg, t, c))(
        jp, prompts, cache)
    return cache, convert.cache_from_jax(jax.tree.map(np.asarray, cache),
                                         tcfg, device="cpu")


def _unstacked(jpool: dict, tcfg) -> list[dict]:
    """JAX's swap pool {('groups', '0'): {leaf: [G, n_slots, ...]}} as one
    dict a layer, in the port's order."""
    out = []
    for g in range(tcfg.pattern_groups):
        for i in range(len(tcfg.block_pattern)):
            out.append({k: v[g] for k, v in jpool[("groups", str(i))].items()})
    return out


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_swap_pool_matches_jax(llm, pool):
    """The mirror's leaves, then a swap-out: bytes and mirror bitwise."""
    _, _, tcfg, _ = llm
    jc, tc = _prefilled(llm, pool)
    jpool = jcache.make_swap_pool(jc, n_slots=4)
    tpool = tcache.make_swap_pool(tc, n_slots=4)
    assert [p for p in tpool] == [("layers", str(i))
                                  for i in range(tcfg.num_layers)]
    for want, got in zip(_unstacked(jpool, tcfg), tpool.values()):
        assert want.keys() == got.keys()
        for name, arr in want.items():
            assert tuple(got[name].shape) == arr.shape, name
            assert convert.to_tensor(arr, "cpu").dtype == got[name].dtype
    pages, slots = [0, 1, 3], [2, 0, 1]
    moved_j = jcache.swap_out_pages(jc, jpool, pages, slots)
    moved_t = tcache.swap_out_pages(tc, tpool, pages, slots)
    assert moved_t == moved_j > 0
    for want, got in zip(_unstacked(jpool, tcfg), tpool.values()):
        for name, arr in want.items():
            np.testing.assert_array_equal(_bits(got[name]), _bits(arr))


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_swap_round_trip_bitwise(llm, pool):
    """Swap pages out, zero them in the pools, swap them back into other
    pages: every pool and scale leaf bitwise, as JAX's round trip."""
    _, _, tcfg, _ = llm
    _, tc = _prefilled(llm, pool)
    before = {(i, k): _bits(v).copy() for i, l in enumerate(tc["layers"])
              for k, v in l.items()}
    pages, slots = [0, 1, 3], [2, 0, 1]
    tpool = tcache.make_swap_pool(tc, n_slots=4)
    tcache.swap_out_pages(tc, tpool, pages, slots)
    for layer in tc["layers"]:
        for name in tcache.pool_leaves(tcache.layout_of(layer)):
            layer[name][pages] = 0
    changed = any(not np.array_equal(_bits(v), before[(i, k)])
                  for i, l in enumerate(tc["layers"]) for k, v in l.items())
    assert changed
    back = tcache.swap_in_pages(tc, tpool, slots, pages)
    for i, layer in enumerate(back["layers"]):
        for k, v in layer.items():
            np.testing.assert_array_equal(_bits(v), before[(i, k)])
    # Into other pages, from the slots in another order.
    tcache.swap_in_pages(tc, tpool, [1, 2, 0], [4, 5, 6])
    for i, layer in enumerate(tc["layers"]):
        for name in tcache.pool_leaves(tcache.layout_of(layer)):
            for src, dst in ((3, 4), (0, 5), (1, 6)):
                np.testing.assert_array_equal(_bits(layer[name][dst]),
                                              before[(i, name)][src])


SWAP_KW = dict(batch=2, max_len=64, paged=True, page_size=8, num_pages=6,
               chunk_size=8, swap_min_tokens=16)


def _run(llm, side, **kw):
    jcfg, jp, tcfg, tp = llm
    prompts = [[int(t) for t in np.random.default_rng(5).integers(
        2, jcfg.vocab_size, n)] for n in (24, 6)]
    if side == "jax":
        eng = jsched.ContinuousBatchingEngine(jcfg, jp, **kw)
        reqs = [jsched.Request(rid=i, prompt=list(p), max_new_tokens=16)
                for i, p in enumerate(prompts)]
    else:
        eng = tsched.ContinuousBatchingEngine(tcfg, tp, device="cpu", **kw)
        reqs = [tsched.Request(rid=i, prompt=list(p), max_new_tokens=16)
                for i, p in enumerate(prompts)]
    eng.run(reqs)
    return eng, {r.rid: list(r.tokens) for r in reqs}


@pytest.mark.parametrize("quant", ["off", "int8"])
@pytest.mark.parametrize("tier", [0, 8])
def test_scheduler_swap_matches_jax(llm, tier, quant):
    """Streams and every counter equal JAX's; with the tier on, swap
    preempts, every page that went out came back, and nothing leaks."""
    kw = dict(SWAP_KW, swap_tier_pages=tier, kv_quant=quant)
    jeng, want = _run(llm, "jax", **kw)
    teng, got = _run(llm, "port", **kw)
    assert got == want
    assert teng.stats.keys() == jeng.stats.keys()
    for name in jeng.stats:
        if name != "admit_s":
            assert teng.stats[name] == jeng.stats[name], name
    if tier:
        assert teng.stats["preempt_swap"] > 0
        assert teng.stats["swap_outs"] == teng.stats["swap_ins"] > 0
        assert sorted(teng._swap_free) == list(range(tier))
    else:
        assert teng.stats["preempt_recompute"] > 0
        assert teng.swap_pool is None
    assert teng.allocator.available == teng.allocator.num_pages


def test_swap_beats_recompute_with_equal_streams(llm):
    """The swap-on run takes fewer steps than the swap-off run and gives
    its streams."""
    off, s_off = _run(llm, "port", swap_tier_pages=0, **SWAP_KW)
    on, s_on = _run(llm, "port", swap_tier_pages=8, **SWAP_KW)
    assert s_on == s_off
    assert on.stats["steps"] < off.stats["steps"]


def test_swap_disabled_for_recurrent_state(llm):
    _, _, tcfg, _ = llm
    cfg = tcfg.replace(block_pattern=("attn", "rglru"), num_layers=4)
    params = tlm.init(cfg, seed=2, device="cpu")
    eng = tsched.ContinuousBatchingEngine(cfg, params, batch=2, max_len=32,
                                          paged=True, page_size=8,
                                          swap_tier_pages=4, device="cpu")
    assert eng.swap_pool is None and eng._swap_free == []
