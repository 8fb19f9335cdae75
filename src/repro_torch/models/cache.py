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
  state          a recurrent carry, never paged: the ``rglru`` kind's h
                 float32 [B, W] and conv [B, cw-1, W] in the cache dtype;
                 ``slstm``'s c / n / m / h float32 [B, d]; ``mlstm``'s C
                 [B, H, dh, dh], n [B, H, dh] and m [B, H], float32 (m, the
                 stabiliser, fills with -10)
  xattn          the whisper decoder's dense self-KV k / v [B, Hkv, S, D]
                 plus the cross-KV xk / xv [B, Hkv, Te, D] filled once at
                 prefill from the encoder output; never paged

Disaggregated serving moves physical pages between two engines' caches
(``export_pages`` / ``adopt_pages`` through the host, ``copy_pages_across``
device to device on the ``page_transfer`` kernel).  Speculative decoding
copies the slots a verify span may write (``snapshot_span``) and writes a
rejected tail back from that copy (``restore_span``).

The latent pool's feature axis is padded to a multiple of 128 as in the
JAX package (whose TPU kernels need the lane width), so caches carry across
leaf for leaf; ``CacheSpec.latent_width`` records the live r + rd.  The
``moe`` kind takes ``attn``'s layouts and ``mla_moe`` takes ``mla``'s.

Writes keep a sharded cache's placements: ``put_slot`` (a decode step's
one position a row) and ``put_prefix`` (a prompt's first T positions)
write a plain tensor as ever, and a ``DTensor`` leaf on each rank's own
shard (its rows, and its part of the position axis under the ``seq``
rules), in place either way.  The paged writes index the never-sharded
page axis, every row into each rank's copy.

The swap tier keeps a host mirror of every pool and scale leaf
(``make_swap_pool``: pinned CPU tensors with the page axis replaced by
swap slots); ``swap_out_pages`` / ``swap_in_pages`` move pages between
the tiers bitwise, one gather and one copy a leaf.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterator

import torch

Params = Any

def is_dtensor(x) -> bool:
    """True for a ``DTensor`` (a leaf of a sharded run)."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _local_like(x, dst, dims: dict):
    """This rank's part of ``x`` for a write into ``dst.to_local()``:
    ``dims`` maps a ``dst`` dim to the ``x`` dim that runs along it; each
    mesh dim that splits one of those ``dst`` dims splits ``x``'s the
    same way, and ``x`` is whole over the others."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    pl = tuple(Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim in dims
               else Replicate() for p in dst.placements)
    if is_dtensor(x):
        return x.redistribute(dst.device_mesh, pl).to_local()
    return distribute_tensor(x, dst.device_mesh, pl,
                             src_data_rank=None).to_local()


def _span(dst, dim: int) -> tuple[int, int]:
    """[start, stop) of ``dst``'s dim ``dim`` this rank holds (an even
    split over each mesh dim that splits it, in mesh-dim order)."""
    from torch.distributed.tensor import Shard
    start, size = 0, dst.shape[dim]
    mesh = dst.device_mesh
    for i, p in enumerate(dst.placements):
        if isinstance(p, Shard) and p.dim == dim:
            size //= mesh.size(i)
            start += mesh.get_local_rank(i) * size
    return start, start + size


def put_slot(dst: torch.Tensor, dim: int, slot: torch.Tensor,
             value: torch.Tensor, keep: torch.Tensor | None = None
             ) -> torch.Tensor:
    """``dst[b, ..., slot[b], ...] = value[b]`` for every row b, in place,
    where ``dim`` is the slot's axis and ``value`` lacks it; rows with
    ``keep`` False (bool[B], or None: every row) are left alone.  A
    ``DTensor`` is written on each rank's own shard: its rows, and the
    slots that fall in its part of ``dim``.  Returns ``dst``."""
    value = value.to(dst.dtype)
    b = dst.shape[0]
    if is_dtensor(dst):
        rest = [d for d in range(1, dst.dim()) if d != dim]
        vdims = {0: 0, **{d: i + 1 for i, d in enumerate(rest)}}
        local = dst.to_local()
        lo, hi = _span(dst, dim)
        slot = _local_like(slot.long(), dst, {0: 0}) - lo
        inside = (slot >= 0) & (slot < hi - lo)
        if keep is not None:
            inside = inside & _local_like(keep, dst, {0: 0})
        rows = torch.arange(local.shape[0], device=local.device)[inside]
        idx = (rows,) + (slice(None),) * (dim - 1) + (slot[inside],)
        local[idx] = _local_like(value, dst, vdims)[inside]
        return dst
    rows = torch.arange(b, device=dst.device)
    idx = (rows,) + (slice(None),) * (dim - 1) + (slot,)
    if keep is not None:
        value = torch.where(
            keep.reshape((b,) + (1,) * (value.dim() - 1)), value, dst[idx])
    dst[idx] = value
    return dst


def put_prefix(dst: torch.Tensor, dim: int, new: torch.Tensor
               ) -> torch.Tensor:
    """Positions [0, T) of ``dst`` along ``dim`` := ``new`` (T =
    ``new.shape[dim]``), in place; a ``DTensor`` on each rank's own
    shard (the positions of [0, T) in its part of ``dim``).  Returns
    ``dst``."""
    t = new.shape[dim]
    new = new.to(dst.dtype)
    if not is_dtensor(dst):
        dst.narrow(dim, 0, t).copy_(new)
        return dst
    lo, hi = _span(dst, dim)
    stop = min(hi, t)
    if stop > lo:
        dims = {d: d for d in range(dst.dim()) if d != dim}
        part = _local_like(new.narrow(dim, lo, stop - lo), dst, dims)
        dst.to_local().narrow(dim, 0, stop - lo).copy_(part)
    return dst


ROLE_KV = "kv"
ROLE_POOL = "pool"
ROLE_SCALE = "scale"
ROLE_TABLE = "table"
ROLE_STATE = "state"

KV_QUANT_MODES = ("off", "int8", "fp8")
SCALE_LEAF = {"k_pages": "k_scales", "v_pages": "v_scales",
              "latent_pages": "latent_scales"}

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


@register_layout("xattn")
def _xattn(kind, cfg, batch, max_len, dtype, **_) -> CacheSpec:
    shape = (batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    xshape = (batch, cfg.num_kv_heads, cfg.encoder.seq_len, cfg.head_dim)
    return CacheSpec(kind, "xattn", (
        Leaf("k", shape, dtype, ROLE_KV),
        Leaf("v", shape, dtype, ROLE_KV),
        Leaf("xk", xshape, dtype, ROLE_KV),
        Leaf("xv", xshape, dtype, ROLE_KV),
    ))


@register_layout("state")
def _state(kind, cfg, batch, max_len, dtype, **_) -> CacheSpec:
    """A recurrent carry: the leaves of its module's init (``rglru
    .init_cache``, ``xlstm.slstm_state`` / ``mlstm_state``), read off a
    meta-device init (no memory), with the module's non-zero fills."""
    from repro_torch.models import rglru, xlstm
    if kind == "rglru":
        tree, fills = rglru.init_cache(cfg, batch, dtype, device="meta"), {}
    else:
        init = {"slstm": xlstm.slstm_state, "mlstm": xlstm.mlstm_state}[kind]
        tree, fills = init(cfg, batch, device="meta"), xlstm.STATE_FILLS
    return CacheSpec(kind, "state", tuple(
        Leaf(name, tuple(t.shape), t.dtype, ROLE_STATE,
             fill=fills.get(name, 0.0))
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
    if kind in ("attn", "moe"):
        return "paged_mha" if paged else "dense"
    if kind == "local":
        # Windowed layers stay dense: already bounded by the window.
        return "dense"
    if kind in ("mla", "mla_moe"):
        return "paged_mla" if paged else "dense_mla"
    if kind in ("rglru", "slstm", "mlstm"):
        return "state"
    if kind == "xattn":
        return "xattn"
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
    frozenset({"c", "n", "m", "h"}): "state",
    frozenset({"C", "n", "m"}): "state",
    frozenset({"k", "v", "xk", "xv"}): "xattn",
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


# ---------------------------------------------------------------------------
# Cross-pool page transfer (prefill/decode disaggregation)
# ---------------------------------------------------------------------------
#
# Disaggregated serving moves *physical* page bytes between two engines'
# caches: the prefill replica fills pages and publishes them through the
# replicated prefix cache; the decode replica adopts the bytes instead of
# recomputing the prefix.  The primitives below iterate the pool leaves of
# every paged layer (scale leaves included), so float, quantized and latent
# layouts move bitwise with no call-site special case.  Layers are kept
# apart here (JAX stacks them on [G]), so a transfer is one kernel launch
# per pool leaf per paged layer.

def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _leaf_mismatch(kind: str, path: tuple, layout: str, name: str,
                   src, dst) -> ValueError:
    return ValueError(
        f"{kind}: pool leaf '{name}' of layer {'/'.join(path)} ({layout}) "
        f"does not match: src {tuple(src.shape)} "
        f"({_dtype_name(src.dtype)}) vs dst {tuple(dst.shape)} "
        f"({_dtype_name(dst.dtype)})")


class _Ids:
    """Page ids moved to each pool's device once per call, not once per
    leaf (a transfer touches every pool leaf of every layer)."""

    def __init__(self, ids, dtype=torch.long):
        self._host = torch.as_tensor(ids)
        self._dtype = dtype
        self._on: dict = {}

    def on(self, device) -> torch.Tensor:
        if device not in self._on:
            self._on[device] = self._host.to(device=device,
                                             dtype=self._dtype)
        return self._on[device]


def export_pages(cache: Params, pages) -> dict:
    """Gather (copies of) the physical rows of ``pages`` from every paged
    layer: ``{'layers/<i>': {leaf: rows [N, ...row]}}``.  Ids past the pool
    read its last row; there are no -1 lanes (exports are explicit).  The
    host-transport half of cross-pool adoption: pair with ``adopt_pages``
    on the far side; device to device, ``copy_pages_across`` moves the
    rows without materializing them."""
    ids = _Ids(pages)
    out: dict = {}
    for path, layout, layer in iter_layers(cache):
        if layout not in PAGED_LAYOUTS:
            continue
        leaves = {}
        for name in pool_leaves(layout):
            pool = layer[name]
            leaves[name] = pool[ids.on(pool.device).clamp(
                0, pool.shape[0] - 1)]
        out["/".join(path)] = leaves
    return out


def adopt_pages(cache: Params, rows: dict, pages, *,
                impl: str = "kernel") -> Params:
    """Scatter ``rows`` (a peer's ``export_pages`` at the same page ids)
    into ``pages`` of this cache's pools, in place (the card runs one
    ``page_transfer`` launch over every leaf, rows as its source pools).
    -1 lanes drop; ids past the pool write its last row; where ids repeat
    the last lane wins.  Raises with the layer and both shapes on any leaf
    mismatch, before anything is written."""
    from repro_torch.kernels import ops
    ids_in = _Ids(pages)
    pairs: dict = {}             # pool pages: [(rows, pool)], one call each

    def ad(path, layout, layer):
        key = "/".join(path)
        got = rows.get(key)
        if got is None:
            raise ValueError(
                f"adopt_pages: no exported rows for layer {key} ({layout})")
        for name in pool_leaves(layout):
            pool = layer[name]
            src = got.get(name)
            if src is None:
                raise ValueError(
                    f"adopt_pages: exported rows for layer {key} ({layout}) "
                    f"are missing pool leaf '{name}'")
            src = torch.as_tensor(src).to(pool.device)
            want = (ids_in.on(pool.device).shape[0],) + tuple(pool.shape[1:])
            if tuple(src.shape) != want or src.dtype != pool.dtype:
                raise _leaf_mismatch("adopt_pages", path, layout, name,
                                     src, pool)
            pairs.setdefault((pool.device, pool.shape[0]), []).append(
                (src.contiguous(), pool))
        return layer

    out = map_layers(cache, ad, layouts=PAGED_LAYOUTS)
    for (dev, num_pages), group in pairs.items():
        ids = ids_in.on(dev)
        tgt = torch.where(ids >= 0, ids.clamp(0, num_pages - 1), -1)
        ops.page_transfer_leaves(group, torch.arange(ids.shape[0],
                                                     device=dev), tgt,
                                 impl=impl)
    return out


def copy_pages_across(src_cache: Params, dst_cache: Params, src,
                      dst=None, *, impl: str = "kernel"
                      ) -> tuple[Params, int]:
    """Device-to-device page adoption: copy pool pages ``src[i]`` of
    ``src_cache`` into pages ``dst[i]`` of ``dst_cache`` in every paged
    layer, in place (``dst`` defaults to ``src``: the replicated server's
    pools share one global page-id space).  -1 lanes drop.

    One ``ops.page_transfer_leaves`` call moves every pool leaf of every
    paged layer, scale leaves included, so every layout lands bitwise (on
    the card one launch a 64-leaf chunk).  The caches must agree on layer
    structure and per-leaf row shape and dtype; page counts may differ;
    a mismatch raises before anything is written.  Returns ``(dst_cache,
    bytes_moved)``: the row bytes of every lane live on both sides, summed
    over leaves and layers (JAX's count).
    """
    from repro_torch.kernels import ops

    src = torch.as_tensor(src)
    dst = src if dst is None else torch.as_tensor(dst)
    if src.shape != dst.shape or src.dim() != 1:
        raise ValueError(
            f"copy_pages_across: src/dst page-id vectors must be matching "
            f"1-D arrays: got src {tuple(src.shape)} vs dst "
            f"{tuple(dst.shape)}")
    n_valid = int(((src >= 0) & (dst >= 0)).sum())
    src_ids, dst_ids = _Ids(src, torch.int32), _Ids(dst, torch.int32)
    src_layers = {path: (layout, layer)
                  for path, layout, layer in iter_layers(src_cache)
                  if layout in PAGED_LAYOUTS}
    pairs: dict = {}             # device: [(src pool, dst pool)]
    moved = 0

    def xfer(path, layout, layer):
        nonlocal moved
        peer = src_layers.get(path)
        if peer is None or peer[0] != layout:
            raise ValueError(
                f"copy_pages_across: source cache has no "
                f"{layout} layer at {'/'.join(path)}"
                + (f" (found {peer[0]})" if peer else ""))
        for name in pool_leaves(layout):
            dpool = layer[name]
            spool = peer[1].get(name)
            if spool is None or spool.dim() != dpool.dim() \
                    or spool.shape[1:] != dpool.shape[1:] \
                    or spool.dtype != dpool.dtype:
                raise _leaf_mismatch(
                    "copy_pages_across", path, layout, name,
                    spool if spool is not None else torch.zeros(()), dpool)
            pairs.setdefault(dpool.device, []).append((spool, dpool))
            moved += dpool[0].numel() * dpool.element_size() * n_valid
        return layer

    out = map_layers(dst_cache, xfer, layouts=PAGED_LAYOUTS)
    for dev, group in pairs.items():
        ops.page_transfer_leaves(group, src_ids.on(dev), dst_ids.on(dev),
                                 impl=impl)
    return out, moved


# ---------------------------------------------------------------------------
# Span snapshot / restore (speculative-decoding rollback)
# ---------------------------------------------------------------------------

# Slot axis of every pool and scale leaf of a paged layer: MHA-family leaves
# are [P, Hkv, ps, ...] (slot axis 2), MLA-family [P, ps, ...] (slot axis
# 1); scale leaves drop the trailing feature axis and keep the slot axis.
_SPAN_SLOT_AXIS = {l: (2 if l.startswith("paged_mha") else 1)
                   for l in PAGED_LAYOUTS}


def _span_positions(start, width: int, device) -> torch.Tensor:
    start = torch.as_tensor(start).to(device=device, dtype=torch.long)
    return start[:, None] + torch.arange(width, device=device)[None, :]


def _pool_geometry(layer: dict, layout: str, name: str) -> tuple[int, int]:
    """(slots a page, pages) of one pool or scale leaf."""
    pool = layer[name]
    return pool.shape[_SPAN_SLOT_AXIS[layout]], pool.shape[0]


def snapshot_span(cache: Params, start, width: int) -> Params:
    """Copies of every cache slot a mixed step writing positions
    [start[b], start[b] + width) could touch: the rollback snapshot taken
    before a speculative verify step (after page growth, so the block
    tables already map the window).

    Dense layouts gather along the sequence axis ([B, W, Hkv, D] and
    [B, W, r]); paged layouts walk the block tables through
    ``kernels.ref.paged_span_gather``, pool and scale leaves alike.  The
    window's (page, slot) pairs are worked out once for all the leaves
    that share a table (every paged layer holds the same one), so a leaf
    costs one gather.  The result is ``{"layers": [...]}`` with one dict
    per layer; recurrent (``state``) and ``xattn`` layers give an empty
    one: a carry is whole-row (``lm.snapshot_state_rows``) and xattn
    layers are not mixed-step servable.  Every leaf is a copy, so the
    verify step's in-place writes leave the snapshot as it was.
    """
    from repro_torch.kernels import ref as kref

    slots: dict = {}
    out = []
    for layer in cache["layers"]:
        layout = layout_of(layer)
        if layout in PAGED_LAYOUTS:
            bt = layer["block_tables"]
            snap = {}
            for name in pool_leaves(layout):
                ps, pages = _pool_geometry(layer, layout, name)
                key = (id(bt), ps, pages)
                if key not in slots:
                    slots[key] = kref.paged_span_slots(
                        bt, torch.as_tensor(start).to(bt.device), width, ps,
                        pages)
                snap[name] = kref.paged_span_gather(
                    layer[name], bt, start, width,
                    slot_axis=_SPAN_SLOT_AXIS[layout], slots=slots[key])
            out.append(snap)
        elif layout in ("dense", "dense_mla"):
            snap = {}
            for name, arr in layer.items():
                key = (arr.shape[0], arr.shape[-2], arr.device)
                if key not in slots:
                    tpos = _span_positions(start, width, arr.device)
                    bidx = torch.arange(arr.shape[0], device=arr.device
                                        )[:, None].expand_as(tpos)
                    slots[key] = bidx, tpos.clamp(0, arr.shape[-2] - 1)
                bidx, spos = slots[key]
                snap[name] = (arr[bidx, :, spos] if layout == "dense"
                              else arr[bidx, spos])
            out.append(snap)
        else:
            out.append({})
    return {"layers": out}


def restore_span(cache: Params, snap: Params, start, lo, hi) -> Params:
    """Write ``snap`` (from :func:`snapshot_span` at the same ``start``)
    back at positions in [lo[b], hi[b]), in place: the rejected-tail
    rollback.  Returns ``cache``.

    It must run against the block tables the snapshot saw, before the
    host frees the tail's grown pages and pushes new tables.  Lanes
    outside the window are dropped, so accepted positions keep the verify
    step's writes bit for bit; rows with lo == hi are untouched.  The
    lanes are worked out once for the leaves that share a table: one
    device-to-host sync a table, not one a leaf.
    """
    from repro_torch.kernels import ref as kref

    lanes: dict = {}
    for layer, s in zip(cache["layers"], snap["layers"]):
        if not s:
            continue
        layout = layout_of(layer)
        if layout in PAGED_LAYOUTS:
            bt = layer["block_tables"]
            for name in pool_leaves(layout):
                ps, pages = _pool_geometry(layer, layout, name)
                key = (id(bt), ps, pages)
                if key not in lanes:
                    lanes[key] = kref.paged_span_lanes(
                        bt, *(torch.as_tensor(x).to(bt.device)
                              for x in (start, lo, hi)),
                        s[name].shape[1], ps, pages)
                kref.paged_span_restore(layer[name], s[name], bt, start, lo,
                                        hi, slot_axis=_SPAN_SLOT_AXIS[layout],
                                        lanes=lanes[key])
            continue
        for name, arr in layer.items():
            key = (arr.shape[0], arr.shape[-2], arr.device)
            if key not in lanes:
                tpos = _span_positions(start, s[name].shape[1], arr.device)
                lo_, hi_ = (torch.as_tensor(x).to(device=arr.device,
                                                  dtype=torch.long)[:, None]
                            for x in (lo, hi))
                keep = ((tpos >= lo_) & (tpos < hi_)
                        & (tpos < arr.shape[-2]))
                b, w = keep.nonzero(as_tuple=True)
                lanes[key] = b, w, tpos[b, w]
            b, w, t = lanes[key]
            vals = s[name][b, w].to(arr.dtype)
            if layout == "dense":
                arr[b, :, t] = vals
            else:
                arr[b, t] = vals
    return cache


# ---------------------------------------------------------------------------
# Tiered page memory: the host swap pool
# ---------------------------------------------------------------------------

def make_swap_pool(cache: Params, n_slots: int) -> dict[tuple, dict]:
    """Host mirror of every paged layer's pool and scale leaves:
    ``{layer_path: {leaf: tensor [n_slots, ...row]}}``, each leaf its
    device shape with the page axis replaced by ``n_slots`` swap slots, in
    pinned memory when the pool lives on the card.  Quantized layouts
    swap their int8 / fp8 codes and f32 scales as they are, so a swapped
    page costs its resident bytes and a swap-in is bitwise."""
    pool: dict[tuple, dict] = {}
    for path, layout, layer in iter_layers(cache):
        if layout not in PAGED_LAYOUTS:
            continue
        leaves = {}
        for name in pool_leaves(layout):
            arr = layer[name]
            leaves[name] = torch.zeros(
                (n_slots,) + tuple(arr.shape[1:]), dtype=arr.dtype,
                pin_memory=arr.device.type == "cuda")
        pool[path] = leaves
    return pool


def _slot_runs(slots) -> tuple[torch.Tensor, list[tuple[int, int, int]]]:
    """The lanes' order by slot, and the runs of consecutive slots in that
    order: [(first slot, count, first lane in the order)].  A run is one
    slice of the mirror, so it moves in one copy (the scheduler's free
    list hands out consecutive slots, so a swap is as a rule one run)."""
    s = torch.as_tensor(slots, dtype=torch.long).reshape(-1)
    order = torch.argsort(s, stable=True)
    ss = s[order].tolist()
    runs, a = [], 0
    for i in range(1, len(ss) + 1):
        if i == len(ss) or ss[i] != ss[i - 1] + 1:
            runs.append((ss[a], i - a, a))
            a = i
    return order, runs


def swap_out_pages(cache: Params, swap_pool: dict, pages, slots) -> int:
    """Copy device pool pages to host swap slots (``pages[i] ->
    slots[i]``), every pool and scale leaf of every paged layer: one
    gather on the pool's device a leaf, then one copy into the mirror a
    run of consecutive slots.  Returns the bytes moved (JAX's count).  On
    the card the copies are asynchronous: a later swap-in of the same
    slots on the stream is ordered after them, but reading the mirror on
    the host needs a sync first."""
    order, runs = _slot_runs(slots)
    ids = _Ids(torch.as_tensor(pages, dtype=torch.long).reshape(-1)[order])
    moved = 0
    for path, layout, layer in iter_layers(cache):
        if layout not in PAGED_LAYOUTS:
            continue
        host = swap_pool[path]
        for name in pool_leaves(layout):
            arr = layer[name]
            rows = arr[ids.on(arr.device)]
            for lo, n, at in runs:
                host[name][lo:lo + n].copy_(rows[at:at + n],
                                            non_blocking=True)
            moved += rows.numel() * rows.element_size()
    return moved


def swap_in_pages(cache: Params, swap_pool: dict, slots, pages) -> Params:
    """Copy host swap slots back into device pool pages (``slots[i] ->
    pages[i]``), in place, values and scales bitwise, so a swapped-in
    request resumes from the cache it was preempted with: one copy to the
    device a run of consecutive slots, one scatter a leaf.  Never reads
    the mirror on the host.  Returns ``cache``."""
    order, runs = _slot_runs(slots)
    ids = _Ids(torch.as_tensor(pages, dtype=torch.long).reshape(-1)[order])
    for path, layout, layer in iter_layers(cache):
        if layout not in PAGED_LAYOUTS:
            continue
        host = swap_pool[path]
        for name in pool_leaves(layout):
            arr = layer[name]
            parts = [host[name][lo:lo + n].to(arr.device, non_blocking=True)
                     for lo, n, _ in runs]
            arr[ids.on(arr.device)] = (parts[0] if len(parts) == 1
                                       else torch.cat(parts))
    return cache
