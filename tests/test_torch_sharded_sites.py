"""The sharded path's contractions and latent rows on local shards.

``xlstm._slstm_cell`` / ``_mlstm_cell`` contract through
``activation.einsum`` and ``mla._latent_rows`` concatenates and pads
through ``activation.last_whole``, so that a sharded run never asks
``DTensor`` for what PyTorch 2.11 refuses (a flatten of two split dims, a
pad).  Here:

* **Plain tensors, bitwise as the plain expressions.**  At xlstm-125m's and
  deepseek-v2-lite-16b's reduced widths, on seeded inputs, the three sites
  equal (``torch.equal``) the expressions written out below: the plain path
  goes to the same ``torch.einsum`` / ``torch.cat`` + ``F.pad`` calls.
* **``DTensor``s on a one-rank gloo (1, 1) mesh**, placed with the batch and
  head (or latent) dims split: the helpers run under
  ``torch_ranks.refusals_of_2_11`` and give the plain results bitwise,
  gradients included, with the rows' placements kept; the plain calls on
  the same ``DTensor``s trip the guard where they flatten two split
  dims (the mLSTM's; the sLSTM's product flattens none); a contraction
  over a split index is refused.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from torch_ranks import RefusedBy211, refusals_of_2_11  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.models import mla, xlstm  # noqa: E402
from repro_torch.sharding import activation  # noqa: E402

XLSTM = configs.reduced(configs.get("xlstm-125m"))
DSV2 = configs.reduced(configs.get("deepseek-v2-lite-16b"), layers=2)
B, T = 4, 6


def _rand(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dtype)


def _slstm_plain(p, cfg, wx_t, state):
    b = state["h"].shape[0]
    h_heads = state["h"].reshape(b, cfg.num_heads, -1).float()
    rh = torch.einsum("bhd,hde->bhe", h_heads, p["r"].float()).reshape(b, -1)
    pre = wx_t.float() + rh
    i_p, f_p, z_p, o_p = torch.chunk(pre, 4, dim=-1)
    m_new = torch.maximum(f_p + state["m"], i_p)
    i_g = torch.exp(i_p - m_new)
    f_g = torch.exp(f_p + state["m"] - m_new)
    c = f_g * state["c"] + i_g * torch.tanh(z_p)
    n = f_g * state["n"] + i_g
    h = torch.sigmoid(o_p) * c / torch.clamp(n, min=1.0)
    return {"c": c, "n": n, "m": m_new, "h": h}, h


def _mlstm_plain(state, q_t, k_t, v_t, i_p, f_p):
    f_log = F.logsigmoid(f_p.float())
    m_new = torch.maximum(f_log + state["m"], i_p.float())
    i_g = torch.exp(i_p - m_new)[..., None]
    f_g = torch.exp(f_log + state["m"] - m_new)[..., None]
    kf, vf, qf = k_t.float(), v_t.float(), q_t.float()
    c = f_g[..., None] * state["C"] + i_g[..., None] * (
        vf[..., :, None] * kf[..., None, :])
    n = f_g * state["n"] + i_g * kf
    denom = torch.clamp(torch.einsum("bhd,bhd->bh", n, qf).abs(), min=1.0)
    h_t = torch.einsum("bhde,bhe->bhd", c, qf) / denom[..., None]
    return {"C": c, "n": n, "m": m_new}, h_t


def _latent_rows_plain(ckv, krope, dp):
    lat = torch.cat([ckv, krope], dim=-1)
    return F.pad(lat, (0, dp - lat.shape[-1]))


def _slstm_args(rng):
    cfg, d = XLSTM, XLSTM.d_model
    p = xlstm.slstm_init(torch.Generator().manual_seed(0), cfg)
    state = {k: _rand(rng, B, d) for k in ("c", "n", "m", "h")}
    return p, cfg, _rand(rng, B, 4 * d, dtype=torch.bfloat16), state


def _mlstm_args(rng):
    h = XLSTM.num_heads
    dh = int(XLSTM.proj_factor * XLSTM.d_model) // h
    state = {"C": _rand(rng, B, h, dh, dh), "n": _rand(rng, B, h, dh),
             "m": _rand(rng, B, h)}
    qkv = [_rand(rng, B, h, dh, dtype=torch.bfloat16) for _ in range(3)]
    return (state, *qkv, _rand(rng, B, h), _rand(rng, B, h))


def _latent_args(rng, dtype):
    m = DSV2.mla
    dp = -(-(m.kv_lora_rank + m.rope_head_dim) // 128) * 128
    return (_rand(rng, B, T, m.kv_lora_rank, dtype=dtype),
            _rand(rng, B, T, m.rope_head_dim, dtype=dtype), dp)


SITES = {
    "slstm_cell": (xlstm._slstm_cell, _slstm_plain, _slstm_args),
    "mlstm_cell": (xlstm._mlstm_cell, _mlstm_plain, _mlstm_args),
    "latent_rows_f32": (mla._latent_rows, _latent_rows_plain,
                        lambda rng: _latent_args(rng, torch.float32)),
    "latent_rows_bf16": (mla._latent_rows, _latent_rows_plain,
                         lambda rng: _latent_args(rng, torch.bfloat16)),
}


def _leaves(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for y in x for v in _leaves(y)]
    return [x]


@pytest.mark.parametrize("site", SITES)
def test_plain_tensors_bitwise_as_the_plain_expressions(site):
    fn, plain, make = SITES[site]
    for seed in range(3):
        args = make(np.random.default_rng(seed))
        got, want = _leaves(fn(*args)), _leaves(plain(*args))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), site


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A one-rank gloo group and a (1, 1) ("data", "model") mesh: a
    ``Shard`` there is the whole tensor, so the helpers' local ops are
    the plain ones, and ``DTensor``'s own ops meet the same placements as
    on a real mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    d = tmp_path_factory.mktemp("pg")
    dist.init_process_group("gloo", init_method=f"file://{d}/pg", rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _dt(x, mesh, *placements, grad=False):
    from torch.distributed.tensor import DTensor
    x = x.detach().clone().requires_grad_(grad)
    return x, DTensor.from_local(x, mesh, list(placements), run_check=False)


# (equation, operand shapes, each operand's placements (data, model),
# whether DTensor's own einsum flattens two split dims there).
EINSUMS = {
    "slstm_recurrent": ("bhd,hde->bhe", [(B, 4, 16), (4, 16, 64)],
                        [("S0", "S1"), ("R", "S0")], False),
    "mlstm_denominator": ("bhd,bhd->bh", [(B, 4, 16), (B, 4, 16)],
                          [("S0", "S1"), ("S0", "S1")], True),
    "mlstm_readout": ("bhde,bhe->bhd", [(B, 4, 16, 16), (B, 4, 16)],
                      [("S0", "S1"), ("S0", "S1")], True),
}


def _placements(names):
    from torch.distributed.tensor import Replicate, Shard
    return [Replicate() if n == "R" else Shard(int(n[1:])) for n in names]


@pytest.mark.parametrize("case", EINSUMS)
def test_einsum_on_local_shards(mesh, case):
    from torch.distributed.tensor import Shard
    eq, shapes, pls, flattens = EINSUMS[case]
    rng = np.random.default_rng(1)
    plain, dts = zip(*(_dt(_rand(rng, *s), mesh, *_placements(p), grad=True)
                       for s, p in zip(shapes, pls)))
    want = torch.einsum(eq, *plain)
    want_grads = torch.autograd.grad(want.square().sum(), plain)
    with refusals_of_2_11():
        got = activation.einsum(eq, *dts)
        grads = torch.autograd.grad(got.square().sum(), dts)
        if flattens:
            # The guard on a later version, 2.11's own refusal on 2.11.
            with pytest.raises(RuntimeError, match="_StridedShard|flatten"):
                torch.einsum(eq, *dts)
    assert got.placements == (Shard(0), Shard(1))
    assert got.shape == want.shape
    assert torch.equal(got.to_local(), want)
    for g, w in zip(grads, want_grads):
        assert torch.equal(g.full_tensor(), w), case


def test_einsum_refuses_a_split_contraction(mesh):
    from torch.distributed.tensor import Replicate, Shard
    rng = np.random.default_rng(2)
    _, n = _dt(_rand(rng, B, 4, 16), mesh, Shard(0), Shard(2))
    _, q = _dt(_rand(rng, B, 4, 16), mesh, Shard(0), Replicate())
    with pytest.raises(ValueError, match="contracts index 'd'"):
        activation.einsum("bhd,bhd->bh", n, q)


def test_latent_rows_on_local_shards(mesh):
    from torch.distributed.tensor import Replicate, Shard
    rng = np.random.default_rng(3)
    ckv, krope, dp = _latent_args(rng, torch.bfloat16)
    _, c = _dt(ckv, mesh, Shard(0), Shard(2))
    _, k = _dt(krope, mesh, Shard(0), Replicate())
    with refusals_of_2_11():
        got = mla._latent_rows(c, k, dp)
        with pytest.raises(RefusedBy211):
            _latent_rows_plain(c, k, dp)
    assert got.placements == (Shard(0), Replicate())
    assert torch.equal(got.full_tensor(), _latent_rows_plain(ckv, krope, dp))
