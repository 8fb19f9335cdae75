"""The port's config copies against the JAX package's, on the CPU.

* Every architecture of ``repro.configs`` has its copy in
  ``repro_torch.configs`` with equal fields (``dataclasses.asdict``), and
  the two ``reduced`` rules give equal configs.
* ``shapes.SHAPES`` are equal, and ``shapes.applicable`` gives JAX's
  answer for every (architecture, shape).
* The reduced dense code models (granite-34b: MQA, biases, LayerNorm, a
  GELU MLP; starcoder2-15b: GQA with the same block; command-r-plus-104b:
  parallel blocks, no biases) with JAX's weights: ``forward``, then
  ``prefill`` and decode steps on a paged cache, float32 logits and
  caches within 1e-4 of JAX's.
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
from repro_torch import convert  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
B, PROMPT, MAX_LEN, PS, STEPS = 2, 7, 24, 8, 3


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
def test_config_copy_equals_jax(arch):
    want = jconfigs.get(arch)
    got = tconfigs.get(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert (dataclasses.asdict(tconfigs.reduced(got))
            == dataclasses.asdict(jconfigs.reduced(want)))


def test_shapes_and_applicability_equal_jax():
    assert ({k: dataclasses.asdict(v)
             for k, v in tconfigs.shapes.SHAPES.items()}
            == {k: dataclasses.asdict(v)
                for k, v in jconfigs.shapes.SHAPES.items()})
    for arch in jconfigs.ARCHS:
        for name in jconfigs.shapes.SHAPES:
            assert (tconfigs.shapes.applicable(
                tconfigs.get(arch), tconfigs.shapes.SHAPES[name])
                == jconfigs.shapes.applicable(
                    jconfigs.get(arch), jconfigs.shapes.SHAPES[name])), \
                (arch, name)


@pytest.mark.parametrize("arch", ["granite-34b", "starcoder2-15b",
                                  "command-r-plus-104b"])
def test_reduced_dense_code_models_match_jax(arch):
    jcfg = jconfigs.reduced(jconfigs.get(arch), d_model=64, vocab=128)
    tcfg = tconfigs.reduced(tconfigs.get(arch), d_model=64, vocab=128)
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      jlm.init(jax.random.PRNGKey(1), jcfg))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    toks = np.random.default_rng(5).integers(
        0, 128, (B, PROMPT)).astype(np.int32)
    want, _ = jlm.forward(jp, jcfg, jnp.asarray(toks))
    got, _ = tlm.forward(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    jc = jlm.set_block_tables(
        jlm.init_cache(jcfg, B, MAX_LEN, dtype=jnp.float32, paged=True,
                       page_size=PS),
        jattn.default_block_tables(B, MAX_LEN, PS))
    tc = tlm.set_block_tables(
        tlm.init_cache(tcfg, B, MAX_LEN, torch.float32, paged=True,
                       page_size=PS, device="cpu"),
        tattn.default_block_tables(B, MAX_LEN, PS))
    want, jc = jlm.prefill(jp, jcfg, jnp.asarray(toks), jc)
    got, tc = tlm.prefill(tp, tcfg, torch.from_numpy(toks), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jdec = jax.jit(lambda p, t, c, s: jlm.decode_step(p, jcfg, t, c, s))
    tok = np.array(jnp.argmax(want, -1), np.int32)
    for i in range(STEPS):
        pos = np.full((B,), PROMPT + i, np.int32)
        want, jc = jdec(jp, tok, jc, pos)
        got, tc = tlm.decode_step(tp, tcfg, torch.from_numpy(tok), tc,
                                  torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        tok = np.array(jnp.argmax(want, -1), np.int32)
    jcache = convert.cache_from_jax(jax.tree.map(np.asarray, jc), tcfg,
                                    device="cpu")
    for lw, lt in zip(jcache["layers"], tc["layers"]):
        for name in ("k_pages", "v_pages"):
            np.testing.assert_allclose(lt[name].numpy(), lw[name].numpy(),
                                       **TOL)
