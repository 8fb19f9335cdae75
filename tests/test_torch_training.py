"""The port's training path against the JAX package, on the CPU.

``lm.loss_fn`` and its gradients: JAX's ``jax.value_and_grad(lm.loss_fn)``
against the port's ``torch.autograd.grad``, both on the plain path
(``impl="ref"``), float32 weights carried across by
``convert.params_from_jax`` and JAX's grad tree through the same converter,
one reduced model a family (dense, MLA + MoE with its aux loss, DeepSeekMoE,
RG-LRU through the plain ``linear_scan``, xLSTM, the whisper encoder on
``enc_frames``, the PaliGemma prefix on ``prefix_embeds``).  Loss, xent and
aux within 1e-5; each grad leaf within 1e-4 of its largest |g| plus 1e-7
(the float32 noise of a leaf whose exact gradient is 0); no leaf without
a grad.

AdamW from identical grads: the schedule, ``grad_norm`` and ``lr`` within
1e-6 relative, the float32 moments within 1e-6 of their leaf's largest |x|
(an element where b1·m and (1-b1)·g nearly cancel keeps the absolute
error of its terms, not a relative one); float32
parameters within 1e-6 relative; bf16 parameters equal except where the
float32 result sits at a bf16 rounding edge (those differ by one bf16 ulp;
the measured share is 0 on these draws, bounded at 0.1 %).

Train steps: three ``make_train_step`` steps from the same parameters and
``convert.opt_state_from_jax`` state, ``remat`` on and off, ``microbatches``
1 and 2, against JAX's jitted steps: loss, xent, ``grad_norm`` and ``lr``
per step within 1e-5 relative, parameters within 1e-5 and the moments
within 1e-5 of their largest |x|.  ``remat`` gives the port's own grads
within 1e-6 of their largest |g|.
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
from repro.training import optimizer as joptim  # noqa: E402
from repro.training import train_step as jtrain_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.training import optimizer as toptim  # noqa: E402
from repro_torch.training import train_step as ttrain_step  # noqa: E402

B, T = 2, 16
FAMILIES = ["olmo-1b", "deepseek-v2-lite-16b", "deepseek-moe-16b",
            "recurrentgemma-2b", "xlstm-125m", "whisper-tiny",
            "paligemma-3b"]


def _models(arch, dtype=jnp.float32):
    jcfg = jconfigs.reduced(jconfigs.get(arch), d_model=64, vocab=128)
    tcfg = tconfigs.reduced(tconfigs.get(arch), d_model=64, vocab=128)
    jp = jax.tree.map(lambda x: x.astype(dtype),
                      jlm.init(jax.random.PRNGKey(0), jcfg))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    return jcfg, jp, tcfg, tp


def _batch(cfg, seed=0, b=B):
    r = np.random.default_rng(seed)
    batch = {"tokens": r.integers(0, cfg.vocab_size, (b, T)).astype(np.int32),
             "targets": r.integers(0, cfg.vocab_size, (b, T)).astype(
                 np.int32),
             "loss_mask": (r.random((b, T)) > 0.2).astype(np.float32)}
    if cfg.is_encdec:
        batch["enc_frames"] = r.normal(
            size=(b, cfg.encoder.seq_len, cfg.d_model)).astype(np.float32)
    if cfg.num_prefix_tokens:
        batch["prefix_embeds"] = r.normal(
            size=(b, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _leaves_close(got, want, rel: float, what: str,
                  floor: float = 1e-7) -> float:
    """Each leaf within ``rel`` of its reference's largest |x|, plus
    ``floor``: a leaf whose exact gradient is 0 (attention's key bias:
    softmax ignores a shift shared by a query's logits) carries float32
    noise alone.  Returns the largest share of the scale seen."""
    worst = 0.0
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.detach().float().numpy()
        w = w.detach().float().numpy()
        assert g.shape == w.shape, (what, i)
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= rel * scale + floor, \
            f"{what} leaf {i} {w.shape}: {err:.3g} > {rel} x {scale:.3g}"
        worst = max(worst, err / max(scale, floor / rel))
    return worst


def _jax_tree_as_port(jtree, tcfg):
    return tree.leaves(convert.params_from_jax(
        jax.tree.map(np.asarray, jtree), tcfg, device="cpu"))


# ---------------------------------------------------------------------------
# loss_fn and its gradients, one reduced model a family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch):
    jcfg, jp, tcfg, tp = _models(arch)
    batch = _batch(tcfg)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, jcfg, b), has_aux=True))(jp, batch)

    leaves = [p.requires_grad_() for p in tree.leaves(tp)]
    loss, m = tlm.loss_fn(tp, tcfg, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    missing = [i for i, g in enumerate(grads) if g is None]
    assert not missing, f"{arch}: leaves {missing} got no gradient"

    loss, m = loss.detach(), {k: v.detach() for k, v in m.items()}
    for got, want in ((loss, jloss), (m["xent"], jm["xent"]),
                      (m["moe_aux"], jm["moe_aux"]),
                      (m["tokens"], jm["tokens"])):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                   atol=1e-5)
    if tcfg.moe is not None:
        assert float(m["moe_aux"]) > 0
    worst = _leaves_close(grads, _jax_tree_as_port(jg, tcfg), 1e-4,
                          f"{arch} grad")
    print(f"{arch}: loss {float(loss):.6f} grad err {worst:.3g} of max|g|")


def test_forward_remat_gives_the_same_grads():
    _, _, tcfg, tp = _models("recurrentgemma-2b")
    batch = _batch(tcfg, seed=3)
    leaves = [p.requires_grad_() for p in tree.leaves(tp)]
    out = []
    for remat in (False, True):
        loss, _ = tlm.loss_fn(tp, tcfg, batch, remat=remat)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    assert float(out[0][0]) == float(out[1][0])
    _leaves_close(out[1][1], out[0][1], 1e-6, "remat grad")


def test_eval_step_matches_jax():
    jcfg, jp, tcfg, tp = _models("deepseek-v2-lite-16b")
    batch = _batch(tcfg, seed=5)
    want = jtrain_step.make_eval_step(jcfg)(jp, batch)
    got = ttrain_step.make_eval_step(tcfg)(tp, batch)
    assert not got["loss"].requires_grad
    for k in ("loss", "xent", "moe_aux", "tokens"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def test_adamw_schedule_matches_jax():
    for opt in (dict(warmup=10, total_steps=100), dict(warmup=0,
                                                       total_steps=7),
                dict(lr_peak=1e-3, warmup=3, total_steps=3)):
        jo, to = joptim.AdamW(**opt), toptim.AdamW(**opt)
        for step in range(0, opt["total_steps"] + 5):
            want = float(jo.lr(jnp.int32(step)))
            np.testing.assert_allclose(to.lr(step), want, rtol=1e-6)


def _adam_tree(r, dtype):
    shapes = {"a": (33, 17), "b": {"c": (64,), "d": (5, 4, 3)}, "e": (1,)}
    return jax.tree.map(
        lambda s: jnp.asarray(r.normal(size=s).astype(np.float32), dtype),
        shapes, is_leaf=lambda s: isinstance(s, tuple))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_adamw_update_matches_jax(dtype, clip):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    r = np.random.default_rng(7)
    opt = dict(lr_peak=1e-2, warmup=2, total_steps=10, clip_norm=clip)
    jo, to = joptim.AdamW(**opt), toptim.AdamW(**opt)
    jp = _adam_tree(r, jdt)
    jstate = jo.init(jp)
    tp = jax.tree.map(lambda a: convert.to_tensor(np.asarray(a), "cpu"), jp)
    tstate = to.init(tp)
    edge = total = 0
    for step in range(4):
        jg = jax.tree.map(lambda a: a * 3.0, _adam_tree(r, jdt))
        tg = jax.tree.map(lambda a: convert.to_tensor(np.asarray(a), "cpu"),
                          jg)
        jp, jstate, jm = jo.update(jg, jstate, jp)
        tp, tstate, tm = to.update(tg, tstate, tp)
        assert int(tstate.step) == int(jstate.step) == step + 1
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-6)
        for tt, jt in ((tstate.mu, jstate.mu), (tstate.nu, jstate.nu)):
            _leaves_close(tree.leaves(tt),
                          [convert.to_tensor(b, "cpu")
                           for b in jax.tree.leaves(jt)], 1e-6, "moment",
                          floor=0)
        for a, b in zip(tree.leaves(tp), jax.tree.leaves(jp)):
            got, want = convert.to_numpy(a), np.asarray(b, np.float32)
            if dtype == "float32":
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
                continue
            # bf16: unequal only where the float32 result rounds at an edge,
            # one bf16 ulp apart.
            diff = got != want
            ulp = np.abs(want) * 2.0 ** -7
            assert np.all(np.abs(got - want)[diff] <= ulp[diff] + 1e-30)
            edge += int(diff.sum())
            total += diff.size
    if dtype == "bfloat16":
        share = edge / total
        print(f"bf16 params at a rounding edge: {share:.4%} of {total}")
        assert share <= 1e-3


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_jax(remat, microbatches):
    jcfg, jp, tcfg, tp = _models("olmo-1b")
    opt = dict(lr_peak=1e-3, warmup=1, total_steps=6)
    jo, to = joptim.AdamW(**opt), toptim.AdamW(**opt)
    jstate = jo.init(jp)
    tstate = convert.opt_state_from_jax(
        jax.tree.map(np.asarray, jstate), tcfg, device="cpu")
    jstep = jax.jit(jtrain_step.make_train_step(
        jcfg, jo, remat=remat, microbatches=microbatches))
    tstep = ttrain_step.make_train_step(tcfg, to, remat=remat,
                                        microbatches=microbatches)
    for s in range(3):
        batch = _batch(tcfg, seed=10 + s, b=4)
        jp, jstate, jm = jstep(jp, jstate, batch)
        tp, tstate, tm = tstep(tp, tstate, batch)
        for k in ("loss", "xent", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=f"step {s} {k}")
    assert int(tstate.step) == int(jstate.step) == 3
    worst = _leaves_close(tree.leaves(tp), _jax_tree_as_port(jp, tcfg), 1e-5,
                          "params")
    for tt, jt in ((tstate.mu, jstate.mu), (tstate.nu, jstate.nu)):
        _leaves_close(tree.leaves(tt), _jax_tree_as_port(jt, tcfg), 1e-5,
                      "moment")
    print(f"remat={remat} microbatches={microbatches}: params {worst:.3g}")


def test_opt_state_from_jax_carries_every_leaf():
    jcfg, jp, tcfg, tp = _models("whisper-tiny")
    jstate = joptim.AdamW().init(jp)
    jstate = jstate._replace(
        step=jnp.int32(5),
        mu=jax.tree.map(lambda a: a + 1.5, jstate.mu))
    st = convert.opt_state_from_jax(jax.tree.map(np.asarray, jstate), tcfg,
                                    device="cpu")
    assert st.step.dtype == torch.int32 and int(st.step) == 5
    for leaves, fill in ((tree.leaves(st.mu), 1.5), (tree.leaves(st.nu), 0)):
        assert len(leaves) == len(tree.leaves(tp))
        for a, p in zip(leaves, tree.leaves(tp)):
            assert a.shape == p.shape and a.dtype == torch.float32
            assert bool((a == fill).all())
