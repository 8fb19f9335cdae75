"""CacheSpec: the typed registry of per-layer KV cache layouts.

Every layer's cache is described by a :class:`CacheSpec` — its layout name
plus typed leaves (name, shape, dtype, role) — built by a registered layout
function; the cache itself is a plain dict ``{"layers": [layer, ...]}`` with
one dict of tensors per layer, in execution order.  (The JAX cache stacks
the layers of each pattern slot on a leading [G] axis for ``lax.scan``; the
port runs a Python loop over layers and keeps them apart —
``convert.cache_from_jax`` unstacks.)

Layouts ported so far:
  dense          [B, Hkv, S, D] K/V (ring when S < the positions written;
                 the ``local`` kind's, paged or not, bounded by the window
                 under ``ring_local_cache``)
  paged_mha      shared K/V pools [P, Hkv, ps, D] + block_tables [B, maxp]
  paged_mha_q8   paged_mha with int8 pools and f32 row scales
                 k_scales / v_scales [P, Hkv, ps] (fill 1.0)
  paged_mha_fp8  the same with float8_e4m3fn pools
  dense_mla      compressed latent stream ckv [B, S, r] + RoPE key
                 krope [B, S, rd]
  paged_mla      latent pool [P, ps, pad128(r + rd)] + block_tables
  paged_mla_q8   int8 latent pool + f32 latent_scales [P, ps] (fill 1.0)
  paged_mla_fp8  the same with a float8_e4m3fn pool
  state          the ``rglru`` kind's recurrent carry: h float32 [B, W] and
                 conv [B, cw-1, W] in the cache dtype; never paged

The latent pool's feature axis is padded to a multiple of 128 as in the
JAX package (whose TPU kernels need the lane width), so caches carry across
leaf for leaf; ``CacheSpec.latent_width`` records the live r + rd.  The
MoE, xLSTM-state and cross-attention layouts of ``repro.models.cache``
raise NotImplementedError naming their ROADMAP.md queue 1 item.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterator

import torch

Params = Any

ROLE_KV = "kv"
ROLE_POOL = "pool"
ROLE_SCALE = "scale"
ROLE_TABLE = "table"
ROLE_STATE = "state"

KV_QUANT_MODES = ("off", "int8", "fp8")
SCALE_LEAF = {"k_pages": "k_scales", "v_pages": "v_scales",
              "latent_pages": "latent_scales"}

# Not yet ported: layout family -> ROADMAP.md queue 1 item.
_LATER = {"moe": "item 11 (remaining families)",
          "mla_moe": "item 11 (remaining families)",
          "slstm": "item 11 (remaining families)",
          "mlstm": "item 11 (remaining families)",
          "xattn": "item 11 (remaining families)"}


def pad128(n: int) -> int:
    return -(-n // 128) * 128


@dataclass(frozen=True)
class Leaf:
    """One typed cache array: its name, full shape, dtype, and role."""
    name: str
    shape: tuple[int, ...]
    dtype: torch.dtype
    role: str
    fill: float = 0.0            # block tables init to -1, arrays to 0

    def init(self, device) -> torch.Tensor:
        return torch.full(self.shape, self.fill, dtype=self.dtype,
                          device=device)


@dataclass(frozen=True)
class CacheSpec:
    """Layout descriptor for one layer's cache."""
    kind: str                    # block kind ("attn", "local", "mla", ...)
    layout: str                  # dense | paged_mha | dense_mla | ... | state
    leaves: tuple[Leaf, ...]
    page_size: int = 0
    num_pages: int = 0
    latent_width: int = 0        # live features of a padded latent pool

    def init(self, device) -> Params:
        return {l.name: l.init(device) for l in self.leaves}


# ---------------------------------------------------------------------------
# Layout functions (the registry)
# ---------------------------------------------------------------------------

_LAYOUTS: dict[str, Callable[..., CacheSpec]] = {}


def register_layout(name: str):
    def deco(fn):
        _LAYOUTS[name] = fn
        return fn
    return deco


@register_layout("dense")
def _dense(kind, cfg, batch, max_len, dtype, **_) -> CacheSpec:
    shape = (batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    return CacheSpec(kind, "dense", (
        Leaf("k", shape, dtype, ROLE_KV),
        Leaf("v", shape, dtype, ROLE_KV),
    ))


@register_layout("paged_mha")
def _paged_mha(kind, cfg, batch, max_len, dtype, *, page_size=64,
               num_pages=None, **_) -> CacheSpec:
    maxp = -(-max_len // page_size)
    if num_pages is None:
        num_pages = batch * maxp
    pool = (num_pages, cfg.num_kv_heads, page_size, cfg.head_dim)
    return CacheSpec(kind, "paged_mha", (
        Leaf("k_pages", pool, dtype, ROLE_POOL),
        Leaf("v_pages", pool, dtype, ROLE_POOL),
        Leaf("block_tables", (batch, maxp), torch.int32, ROLE_TABLE,
             fill=-1),
    ), page_size=page_size, num_pages=num_pages)


@register_layout("dense_mla")
def _dense_mla(kind, cfg, batch, max_len, dtype, **_) -> CacheSpec:
    m = cfg.mla
    return CacheSpec(kind, "dense_mla", (
        Leaf("ckv", (batch, max_len, m.kv_lora_rank), dtype, ROLE_KV),
        Leaf("krope", (batch, max_len, m.rope_head_dim), dtype, ROLE_KV),
    ))


@register_layout("paged_mla")
def _paged_mla(kind, cfg, batch, max_len, dtype, *, page_size=64,
               num_pages=None, **_) -> CacheSpec:
    m = cfg.mla
    width = m.kv_lora_rank + m.rope_head_dim
    maxp = -(-max_len // page_size)
    if num_pages is None:
        num_pages = batch * maxp
    return CacheSpec(kind, "paged_mla", (
        Leaf("latent_pages", (num_pages, page_size, pad128(width)), dtype,
             ROLE_POOL),
        Leaf("block_tables", (batch, maxp), torch.int32, ROLE_TABLE,
             fill=-1),
    ), page_size=page_size, num_pages=num_pages, latent_width=width)


@register_layout("state")
def _state(kind, cfg, batch, max_len, dtype, **_) -> CacheSpec:
    """The ``rglru`` carry: ``models.rglru.init_cache``'s leaves, read off
    a meta-device init (no memory)."""
    from repro_torch.models import rglru
    tree = rglru.init_cache(cfg, batch, dtype, device="meta")
    return CacheSpec(kind, "state", tuple(
        Leaf(name, tuple(t.shape), t.dtype, ROLE_STATE)
        for name, t in tree.items()))


def _quantized(base: str, layout: str, qdtype, kind, cfg, batch, max_len,
               dtype, **kw) -> CacheSpec:
    """Derive a quantized layout from its float layout: pool leaves store
    the quantized dtype and each gains an f32 scale leaf of the pool shape
    minus the feature axis (one scale per pool row within each page).
    Scales init to 1.0: a scale is never zero, even for untouched pages."""
    spec = _LAYOUTS[base](kind, cfg, batch, max_len, dtype, **kw)
    leaves: list[Leaf] = []
    for l in spec.leaves:
        if l.role != ROLE_POOL:
            leaves.append(l)
            continue
        leaves.append(Leaf(l.name, l.shape, qdtype, ROLE_POOL))
        leaves.append(Leaf(SCALE_LEAF[l.name], l.shape[:-1], torch.float32,
                           ROLE_SCALE, fill=1.0))
    return CacheSpec(kind, layout, tuple(leaves), page_size=spec.page_size,
                     num_pages=spec.num_pages, latent_width=spec.latent_width)


@register_layout("paged_mha_q8")
def _paged_mha_q8(kind, cfg, batch, max_len, dtype, **kw) -> CacheSpec:
    return _quantized("paged_mha", "paged_mha_q8", torch.int8, kind, cfg,
                      batch, max_len, dtype, **kw)


@register_layout("paged_mha_fp8")
def _paged_mha_fp8(kind, cfg, batch, max_len, dtype, **kw) -> CacheSpec:
    return _quantized("paged_mha", "paged_mha_fp8", torch.float8_e4m3fn,
                      kind, cfg, batch, max_len, dtype, **kw)


@register_layout("paged_mla_q8")
def _paged_mla_q8(kind, cfg, batch, max_len, dtype, **kw) -> CacheSpec:
    return _quantized("paged_mla", "paged_mla_q8", torch.int8, kind, cfg,
                      batch, max_len, dtype, **kw)


@register_layout("paged_mla_fp8")
def _paged_mla_fp8(kind, cfg, batch, max_len, dtype, **kw) -> CacheSpec:
    return _quantized("paged_mla", "paged_mla_fp8", torch.float8_e4m3fn,
                      kind, cfg, batch, max_len, dtype, **kw)


# ---------------------------------------------------------------------------
# Kind -> layout routing
# ---------------------------------------------------------------------------

def layer_kinds(cfg) -> list[str]:
    """Block kind of every layer in execution order: the pattern repeated
    ``pattern_groups`` times, then the tail remainder (JAX's scan order)."""
    return list(cfg.block_pattern) * cfg.pattern_groups + list(
        cfg.tail_blocks)


def layout_for(kind: str, cfg, *, paged: bool) -> str:
    """Which layout a block kind uses under the requested paging mode."""
    if kind == "attn":
        return "paged_mha" if paged else "dense"
    if kind == "local":
        # Windowed layers stay dense: already bounded by the window.
        return "dense"
    if kind == "mla":
        return "paged_mla" if paged else "dense_mla"
    if kind == "rglru":
        return "state"
    if kind in _LATER:
        raise NotImplementedError(
            f"the {kind!r} cache layout is not ported yet: ROADMAP.md "
            f"queue 1 {_LATER[kind]}")
    raise ValueError(f"unknown block kind {kind}")


def quant_layout(layout: str, kv_quant: str) -> str:
    """Quantized variant of a paged layout (identity for 'off' and for
    non-paged layouts: a dense cache rewrites whole rows per step, so only
    page pools quantize)."""
    if kv_quant in (None, "", "off"):
        return layout
    if kv_quant not in KV_QUANT_MODES:
        raise ValueError(f"unknown kv_quant {kv_quant!r}: pick one of "
                         f"{KV_QUANT_MODES}")
    if layout not in ("paged_mha", "paged_mla"):
        return layout
    return layout + ("_q8" if kv_quant == "int8" else "_fp8")


def spec_for(kind: str, cfg, batch: int, max_len: int,
             dtype=torch.bfloat16, *, paged: bool = False,
             page_size: int = 64, num_pages: int | None = None,
             kv_quant: str = "off") -> CacheSpec:
    layout = quant_layout(layout_for(kind, cfg, paged=paged), kv_quant)
    if kind == "local" and cfg.ring_local_cache and cfg.window:
        max_len = min(max_len, cfg.window)
    return _LAYOUTS[layout](kind, cfg, batch, max_len, dtype,
                            page_size=page_size, num_pages=num_pages)


def model_cache_specs(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                      *, paged: bool = False, page_size: int = 64,
                      num_pages: int | None = None,
                      kv_quant: str = "off") -> dict[str, Any]:
    """The registry for one model: {"layers": [spec per layer]}."""
    return {"layers": [spec_for(kind, cfg, batch, max_len, dtype,
                                paged=paged, page_size=page_size,
                                num_pages=num_pages, kv_quant=kv_quant)
                       for kind in layer_kinds(cfg)]}


# ---------------------------------------------------------------------------
# Layout detection + typed traversal
# ---------------------------------------------------------------------------

_LEAFSETS: dict[frozenset, str] = {
    frozenset({"k", "v"}): "dense",
    frozenset({"k_pages", "v_pages", "block_tables"}): "paged_mha",
    frozenset({"ckv", "krope"}): "dense_mla",
    frozenset({"latent_pages", "block_tables"}): "paged_mla",
    # int8 and fp8 share leaf names; layout_of tells them by pool dtype.
    frozenset({"k_pages", "v_pages", "k_scales", "v_scales",
               "block_tables"}): "paged_mha_q8",
    frozenset({"latent_pages", "latent_scales",
               "block_tables"}): "paged_mla_q8",
    frozenset({"h", "conv"}): "state",
}

# Every leaf that travels with its pages (pools AND their scales), so page
# copies move values and scales together.
_POOL_LEAVES = {"paged_mha": ("k_pages", "v_pages"),
                "paged_mha_q8": ("k_pages", "v_pages", "k_scales",
                                 "v_scales"),
                "paged_mha_fp8": ("k_pages", "v_pages", "k_scales",
                                  "v_scales"),
                "paged_mla": ("latent_pages",),
                "paged_mla_q8": ("latent_pages", "latent_scales"),
                "paged_mla_fp8": ("latent_pages", "latent_scales")}
PAGED_LAYOUTS = tuple(_POOL_LEAVES)


def layout_of(layer_cache) -> str | None:
    """Layout name of one layer's cache dict (None if not a layer dict)."""
    if not isinstance(layer_cache, dict):
        return None
    name = _LEAFSETS.get(frozenset(layer_cache.keys()))
    if name in ("paged_mha_q8", "paged_mla_q8"):
        pool = layer_cache["k_pages" if "k_pages" in layer_cache
                           else "latent_pages"]
        if pool.dtype == torch.float8_e4m3fn:
            return name[:-len("_q8")] + "_fp8"
    return name


def iter_layers(cache: Params, path: tuple[str, ...] = ()
                ) -> Iterator[tuple[tuple[str, ...], str, dict]]:
    """Yield (path, layout, layer_dict) for every recognized layer cache."""
    if isinstance(cache, (list, tuple)):
        for i, v in enumerate(cache):
            yield from iter_layers(v, path + (str(i),))
        return
    if not isinstance(cache, dict):
        return
    layout = layout_of(cache)
    if layout is not None:
        yield path, layout, cache
        return
    for k, v in cache.items():
        yield from iter_layers(v, path + (str(k),))


def map_layers(cache: Params, fn, *, layouts: tuple[str, ...] | None = None
               ) -> Params:
    """Rebuild the cache tree with ``fn(path, layout, layer)`` applied to
    every layer dict (matching ``layouts`` when given, all otherwise)."""
    def rec(tree, path):
        if isinstance(tree, (list, tuple)):
            return [rec(v, path + (str(i),)) for i, v in enumerate(tree)]
        if not isinstance(tree, dict):
            return tree
        layout = layout_of(tree)
        if layout is not None:
            if layouts is None or layout in layouts:
                return fn(path, layout, tree)
            return tree
        return {k: rec(v, path + (str(k),)) for k, v in tree.items()}

    return rec(cache, ())


def pool_leaves(layout: str) -> tuple[str, ...]:
    return _POOL_LEAVES.get(layout, ())


# ---------------------------------------------------------------------------
# Block tables: install / read / validate
# ---------------------------------------------------------------------------

def set_block_tables(cache: Params, block_tables) -> Params:
    """Install one [B, maxp] block table into every paged layer.

    Layers share the mapping (same tokens, same pages-per-row), so every
    layer holds the same int32 tensor.  The shape is validated against each
    layer's own table — a mismatched table would silently address the wrong
    pages otherwise.
    """
    bt = torch.as_tensor(block_tables)
    for path, layout, layer in iter_layers(cache):
        if layout not in PAGED_LAYOUTS:
            continue
        want = tuple(layer["block_tables"].shape)
        if tuple(bt.shape) != want:
            raise ValueError(
                f"block table shape {tuple(bt.shape)} does not match layer "
                f"{'/'.join(path)} ({layout}): expected [B, maxp] = {want}")
        bt = bt.to(device=layer["block_tables"].device, dtype=torch.int32)

    def install(path, layout, layer):
        return dict(layer, block_tables=bt)

    return map_layers(cache, install, layouts=PAGED_LAYOUTS)


def get_block_tables(cache: Params) -> torch.Tensor | None:
    """The [B, maxp] block table shared by the paged layers (None if dense)."""
    for _, layout, layer in iter_layers(cache):
        if layout in PAGED_LAYOUTS:
            return layer["block_tables"]
    return None


# ---------------------------------------------------------------------------
# Page copy (COW) — device-side page duplication across every paged layer
# ---------------------------------------------------------------------------

def copy_pages(cache: Params, src, dst) -> Params:
    """Copy pool pages ``src[i] -> dst[i]`` in every paged layer, in place.

    src/dst: i32[N] page ids (pad unused lanes with -1: those copies drop).
    """
    src = torch.as_tensor(src).long()
    dst = torch.as_tensor(dst).long()
    if src.shape != dst.shape or src.dim() != 1:
        raise ValueError(
            f"copy_pages: src/dst page-id vectors must be matching 1-D "
            f"arrays: got src {tuple(src.shape)} vs dst {tuple(dst.shape)}")
    keep = (src >= 0) & (dst >= 0)
    for _, layout, layer in iter_layers(cache):
        for name in pool_leaves(layout):
            pool = layer[name]
            s, d = src[keep].to(pool.device), dst[keep].to(pool.device)
            pool[d] = pool[s]            # gather first, then scatter
    return cache
