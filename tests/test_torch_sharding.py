"""The port's partitioner, ZeRO-1 specs, activation constraints and meshes
against JAX's, on the CPU.

Specs are metadata: both packages' ``Partitioner``s run on the same mesh
stand-in (axis names and a size dict, as ``tests/test_sharding.py`` builds
its ``FakeMesh``).  JAX's specs of its stacked trees (``lm.abstract_params``,
``lm.init_cache``) are unstacked as ``convert`` unstacks the trees (each
``groups`` / encoder ``blocks`` leaf drops its leading, never sharded,
layer axis) and must equal the port's specs of the converted trees, for
every architecture, with FSDP on and off, every MLA cache mode, dense and
paged caches.  On a 4-rank gloo group (a 2 × 2 ``DeviceMesh``) every leaf
distributed with the partitioner's ``DTensor`` placements must hold the
local shard its spec says.
"""
from __future__ import annotations

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.sharding.partition import Partitioner as JPartitioner  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.sharding import mesh as smesh  # noqa: E402
from repro_torch.sharding import activation  # noqa: E402
from repro_torch.sharding.partition import P  # noqa: E402
from repro_torch.sharding.partition import Partitioner  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from torch_ranks import run_ranks  # noqa: E402

ARCHS = sorted(jconfigs.ARCHS)


class FakeMesh:
    """Mesh stand-in with arbitrary axis sizes (specs never touch
    devices)."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2}}


def _zeros(abstract):
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), abstract)


def _flat(t, path=()):
    """{path: spec} of a spec tree of dicts and lists (specs as tuples)."""
    if isinstance(t, dict):
        return {k: v for key, sub in t.items()
                for k, v in _flat(sub, path + (str(key),)).items()}
    if isinstance(t, list):
        return {k: v for i, sub in enumerate(t)
                for k, v in _flat(sub, path + (str(i),)).items()}
    return {path: tuple(P(*t))}


def _map(t, fn):
    return {k: _map(v, fn) for k, v in t.items()} if isinstance(t, dict) \
        else fn(t)


def _drop_layer_axis(spec):
    assert spec[0] is None, spec
    return tuple(spec)[1:]


def _unstack(specs: dict, cfg, leaf=_drop_layer_axis) -> dict:
    """JAX's spec tree of a stacked tree in the port's layout (as
    ``convert.params_from_jax`` / ``cache_from_jax`` lay out trees), each
    stacked leaf's spec through ``leaf``."""
    layers = [_map(specs["groups"][str(i)], leaf)
              for _ in range(cfg.pattern_groups)
              for i in range(len(cfg.block_pattern))]
    layers += [specs["tail"][str(i)] for i in range(len(cfg.tail_blocks))]
    out = {k: v for k, v in specs.items()
           if k not in ("groups", "tail", "encoder")}
    out["layers"] = layers
    if "encoder" in specs:
        e = specs["encoder"]
        out["encoder"] = {"pos": e["pos"], "norm": e["norm"], "blocks": [
            _map(e["blocks"], leaf)
            for _ in range(cfg.encoder.num_layers)]}
    return out


def _port_cfg(arch):
    from repro_torch import configs as tconfigs
    return tconfigs.reduced(tconfigs.get(arch))


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch, mesh, fsdp):
    cfg = jconfigs.reduced(jconfigs.get(arch))
    jparams = _zeros(jlm.abstract_params(cfg))
    tparams = convert.params_from_jax(jparams, _port_cfg(arch),
                                      device="cpu")
    stand_in = FakeMesh(MESHES[mesh])
    want = _unstack(JPartitioner(stand_in, fsdp=fsdp).params_specs(jparams),
                    cfg)
    got = Partitioner(stand_in, fsdp=fsdp).params_specs(tparams)
    assert _flat(got) == _flat(want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_jax(arch, mesh):
    """Dense and paged caches, every MLA cache mode, batch sharded and
    not."""
    cfg = jconfigs.reduced(jconfigs.get(arch))
    stand_in = FakeMesh(MESHES[mesh])
    for paged in (False, True):
        jcache = _zeros(jax.eval_shape(lambda: jlm.init_cache(
            cfg, 8, 256, paged=paged, page_size=64)))
        tcache = convert.cache_from_jax(jcache, _port_cfg(arch),
                                        device="cpu")
        for mla_cache in ("latent", "replicated", "seq"):
            for shard_batch in (True, False):
                jpart = JPartitioner(stand_in, fsdp=False,
                                     mla_cache=mla_cache)
                want = jax.tree_util.tree_map_with_path(
                    lambda path, leaf: jpart.cache_entry_spec(
                        tuple(str(getattr(k, "key", k)) for k in path),
                        np.shape(leaf), shard_batch=shard_batch,
                        stacked="groups" in str(path)), jcache)
                got = Partitioner(stand_in, fsdp=False,
                                  mla_cache=mla_cache).cache_specs(
                    tcache, shard_batch=shard_batch)
                assert _flat(got) == _flat(_unstack(want, cfg)), (
                    paged, mla_cache, shard_batch)


def _layer_axis_sharded(spec):
    """JAX's moment spec of a stacked leaf in the port's layout: its layer
    axis dropped, or marked ``"LAYERS"`` where ZeRO-1 sharded it."""
    return ("LAYERS", *tuple(spec)[1:]) if spec[0] is not None \
        else tuple(spec)[1:]


def _shapes(t, path=()):
    if isinstance(t, dict):
        return {k: v for key, sub in t.items()
                for k, v in _shapes(sub, path + (str(key),)).items()}
    if isinstance(t, list):
        return {k: v for i, sub in enumerate(t)
                for k, v in _shapes(sub, path + (str(i),)).items()}
    return {path: tuple(t.shape)}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_specs_match_jax(arch, mesh):
    """ZeRO-1 moment specs are JAX's rule on each layer's own shape.

    JAX's moments are stacked [G, ...] a block-pattern slot (an encoder's
    [L, ...]) and its rule shards the first replicated, divisible dim: the
    layer axis itself wherever G % data_size == 0 (full OLMo-1B's 16
    layers on the production mesh's data = 16; here the reduced models'
    layer counts on the 2 × 2 mesh).  The port has no layer axis, so there
    it shards the first such dim of the layer's own shape.  That known
    difference is asserted leaf by leaf; every other leaf equals JAX's.
    The models have two pattern groups, so the 2 × 2 mesh shows it."""
    from repro_torch import configs as tconfigs
    full = jconfigs.get(arch)
    layers = 2 * len(full.block_pattern) + len(full.tail_blocks)
    cfg = jconfigs.reduced(full, layers=layers)
    jparams = _zeros(jlm.abstract_params(cfg))
    tparams = convert.params_from_jax(
        jparams, tconfigs.reduced(tconfigs.get(arch), layers=layers),
        device="cpu")
    stand_in = FakeMesh(MESHES[mesh])
    jpart, tpart = JPartitioner(stand_in), Partitioner(stand_in)
    axes, size = jpart.batch_axes, jpart.data_size
    got = _flat(topt.zero1_specs(tpart.params_specs(tparams), tparams,
                                 axes, size))
    stacked = _flat(_unstack(jopt.zero1_specs(
        jpart.params_specs(jparams), jparams, axes, size), cfg,
        leaf=_layer_axis_sharded))
    layer_specs = _flat(_unstack(jpart.params_specs(jparams), cfg))
    shapes = _shapes(tparams)
    assert set(got) == set(stacked) == set(shapes)
    gap = 0
    for path, spec in got.items():
        # JAX's rule applied to this layer's own spec and shape.
        per_layer = tuple(P(*jopt.zero1_specs(
            JP(*layer_specs[path]),
            jax.ShapeDtypeStruct(shapes[path], np.float32), axes, size)))
        assert spec == per_layer, path
        if stacked[path][:1] == ("LAYERS",):
            gap += 1
            assert stacked[path][1:] == layer_specs[path], path
        else:
            assert spec == stacked[path], path
    layer_counts = [cfg.pattern_groups] + (
        [cfg.encoder.num_layers] if cfg.encoder is not None else [])
    assert (gap > 0) == any(g % size == 0 and g >= size
                            for g in layer_counts)
    assert (gap > 0) == (mesh == "2x2")


def test_spec_normalises_one_axis_tuples():
    assert P(("data",), "model") == P("data", "model")
    assert tuple(P(None, ("pod", "data"))) == (None, ("pod", "data"))


def test_constrain_unbound_returns_its_input():
    x = torch.zeros(2, 3)
    assert activation.constrain(x, "batch", None) is x
    with activation.bind(activation.standard_binding(("data",))):
        # A plain tensor has no placement to constrain.
        assert activation.constrain(x, "batch", None) is x
    assert activation.standard_binding(("pod", "data"), seq_parallel=False) \
        == {"batch": ("pod", "data"), "vocab": "model", "heads": "model",
            "ffn": "model", "seq": None}


def test_meshes_match_jax(monkeypatch):
    """The production and debug meshes' shapes and axis names, and
    ``dp_axes``, equal JAX's (both mesh builders captured, not run)."""
    seen = []
    monkeypatch.setattr(jmesh.jax, "make_mesh",
                        lambda shape, axes: seen.append((shape, axes)))
    monkeypatch.setattr(tmesh, "_device_mesh",
                        lambda dev, shape, names: seen.append(
                            (tuple(shape), tuple(names), dev)))
    for multi_pod in (False, True):
        jmesh.make_production_mesh(multi_pod=multi_pod)
        tmesh.make_production_mesh(multi_pod=multi_pod)
        assert seen[-1][:2] == seen[-2]
        assert seen[-1][2] == "cuda"
    jmesh.make_debug_mesh(2, 4)
    tmesh.make_debug_mesh(2, 4, device_type="cpu")
    assert seen[-1] == seen[-2] + ("cpu",)
    for shape in MESHES.values():
        stand_in = FakeMesh(shape)
        assert tmesh.dp_axes(stand_in) == jmesh.dp_axes(stand_in)
        assert smesh.axis_sizes(stand_in) == shape
    sm = smesh.StackedMesh((4, 2), ("data", "model"))
    assert tmesh.dp_axes(sm) == ("data",)
    assert smesh.local_replicas(sm, ("data",)) == 4
    assert not any(hasattr(tmesh, k) for k in dir(jmesh) if k.isupper())


GLOO_ARCHS = ("olmo-1b", "deepseek-v2-lite-16b")


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    trees, cases = {}, {}
    for arch in GLOO_ARCHS:
        cfg = jconfigs.reduced(jconfigs.get(arch))
        tcfg = _port_cfg(arch)
        params = convert.params_from_jax(
            _zeros(jlm.abstract_params(cfg)), tcfg, device="cpu")
        cache = convert.cache_from_jax(_zeros(jax.eval_shape(
            lambda c=cfg: jlm.init_cache(c, 8, 256, paged=True,
                                         page_size=64))), tcfg, device="cpu")
        trees[arch] = (params, cache)
        for fsdp in (False, True):
            cases[f"{arch}/{fsdp}"] = dict(params=params, cache=cache,
                                           fsdp=fsdp)
    logits = torch.arange(8 * 3 * 64, dtype=torch.float32).reshape(8, 3, 64)
    outs = run_ranks("sharding", dict(cases=cases, logits=logits),
                     tmp_path_factory.mktemp("gloo_sharding"))
    return trees, outs


def _local_shape(shape, spec, sizes):
    out = []
    for dim, part in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = (part,) if isinstance(part, str) else (part or ())
        n = math.prod(sizes[a] for a in axes)
        assert dim % n == 0, (shape, spec)
        out.append(dim // n)
    return tuple(out)


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", GLOO_ARCHS)
def test_dtensor_shards_follow_the_specs(gloo, arch, fsdp):
    trees, outs = gloo
    params, cache = trees[arch]
    sizes = {"data": 2, "model": 2}
    part = Partitioner(FakeMesh(sizes), fsdp=fsdp)
    for name, tree, specs in (
            ("params", params, part.params_specs(params)),
            ("cache", cache, part.cache_specs(cache))):
        flat_specs = _flat(specs)
        for rank_out in outs:
            got = rank_out[f"{arch}/{fsdp}"][name]
            assert set(got) == set(flat_specs)
            for path, shape in got.items():
                leaf = tree
                for k in path:
                    leaf = leaf[int(k)] if isinstance(leaf, list) else leaf[k]
                assert shape == _local_shape(tuple(leaf.shape),
                                             flat_specs[path], sizes), path
    sharded = sum(any(p is not None for p in s)
                  for s in _flat(part.params_specs(params)).values())
    assert sharded > 0
    for rank_out in outs:
        # logits [8, 3, 64] under ("batch", None, "vocab"): rows over
        # data, vocab over model, the values unchanged.
        assert rank_out["constrained"] == ((4, 3, 32), True)
        assert rank_out["debug_mesh"] == ({"data": 2, "model": 2},
                                          ("data",))
