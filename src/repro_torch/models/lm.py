"""Top-level language model: embedding → blocks → head (tied or not).

Parameters are a dict ``{"embed": {"w"}, "final_norm": {...}, "layers":
[block params per layer], ("head": {"w"})}`` with the JAX tree's leaf names
and layouts; where JAX stacks each pattern slot's layers on a [G] axis for
``lax.scan``, the port keeps one dict per layer and loops over them
(``convert.params_from_jax`` unstacks a JAX tree).

Entry points mirror ``repro.models.lm``: ``forward``, ``init_cache``,
``prefill``, ``decode_step``, ``mixed_step`` and, for recurrent (``state``
layout) layers, ``reset_state_rows``, ``snapshot_state_rows`` and
``restore_state_rows``.  ``impl="kernel"`` runs the kernels where the
tensors live (the Hopper kernels on the card, the plain versions on the
CPU); ``impl="ref"`` takes the plain versions.  Attention caches are
updated in place; recurrent layers hand back new state tensors.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch import resolve_device
from repro_torch.models import blocks, common
from repro_torch.models import cache as cache_mod
from repro_torch.models.blocks import BlockCtx
from repro_torch.models.config import ModelConfig

Params = Any

CHUNKED_THRESHOLD = 8192


def _check_supported(cfg: ModelConfig) -> None:
    for kind in set(cache_mod.layer_kinds(cfg)):
        blocks.check_kind(kind)
    if cfg.num_prefix_tokens or cfg.is_encdec:
        raise NotImplementedError(
            "prefix-LM and encoder-decoder models are not ported yet: "
            "ROADMAP.md queue 1 item 11 (remaining families)")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init(cfg: ModelConfig, *, seed: int = 0, device=None) -> Params:
    """Random bf16 weights from a seeded ``torch.Generator`` on ``device``
    (the card unless ``device="cpu"``).  The draws are the port's own: for
    the JAX reference's weights use ``convert.params_from_jax``."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, v = cfg.d_model, cfg.vocab_size
    p: dict[str, Any] = {
        "embed": {"w": (torch.randn((v, d), generator=gen, device=dev)
                        * d ** -0.5).to(common.PARAM_DTYPE)},
        "final_norm": common.norm_init(d, cfg.norm_type, dev),
    }
    if not cfg.tie_embeddings:
        p["head"] = common.dense_init(gen, d, v)
    p["layers"] = [blocks.block_init(kind, gen, cfg)
                   for kind in cache_mod.layer_kinds(cfg)]
    return p


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def _embed(p: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = p["embed"]["w"][tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _head(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ p["embed"]["w"].t().to(x.dtype)
    else:
        logits = common.dense(p["head"], x)
    return common.softcap(logits.float(), cfg.logit_softcap)


def _tokens(tokens, device) -> torch.Tensor:
    return torch.as_tensor(tokens, device=device)


def _make_ctx(cfg: ModelConfig, t: int, device,
              lengths: Optional[torch.Tensor] = None) -> BlockCtx:
    if t > CHUNKED_THRESHOLD:
        raise NotImplementedError(
            f"prompts longer than {CHUNKED_THRESHOLD} tokens need the "
            "blockwise attention path, not ported yet: ROADMAP.md queue 2 "
            "(flash_attention)")
    mask_full = common.make_mask(t, t, causal=True, device=device)
    mask_local = (common.make_mask(t, t, causal=True, window=cfg.window,
                                   device=device)
                  if "local" in cfg.block_pattern else None)
    if lengths is not None:
        valid = (torch.arange(t, device=device)[None, :]
                 < lengths[:, None])                            # [B, T]
        mask_full = mask_full[None] & valid[:, None, :]
        if mask_local is not None:
            mask_local = mask_local[None] & valid[:, None, :]
    return BlockCtx(positions=torch.arange(t, device=device),
                    mask_full=mask_full, mode="full", lengths=lengths,
                    mask_local=mask_local)


def _run_blocks(p: Params, cfg: ModelConfig, x: torch.Tensor,
                ctx: BlockCtx, cache: Params | None
                ) -> tuple[torch.Tensor, Params | None]:
    kinds = cache_mod.layer_kinds(cfg)
    layers = cache["layers"] if cache is not None else [None] * len(kinds)
    new_layers = []
    for kind, lp, lc in zip(kinds, p["layers"], layers):
        x, lc = blocks.block_apply(kind, lp, cfg, x, ctx, lc)
        new_layers.append(lc)
    if cache is None:
        return x, None
    return x, dict(cache, layers=new_layers)


def _final(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = common.apply_norm(p["final_norm"], x, cfg.norm_type, cfg.norm_eps)
    return _head(p, cfg, x)


# ---------------------------------------------------------------------------
# Full-sequence forward
# ---------------------------------------------------------------------------

def forward(p: Params, cfg: ModelConfig, tokens
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens: [B, T] -> (logits [B, T, V] float32, aux loss 0)."""
    _check_supported(cfg)
    dev = p["embed"]["w"].device
    tokens = _tokens(tokens, dev)
    x = _embed(p, cfg, tokens)
    ctx = _make_ctx(cfg, x.shape[1], dev)
    x, _ = _run_blocks(p, cfg, x, ctx, None)
    return _final(p, cfg, x), torch.zeros((), device=dev)


# ---------------------------------------------------------------------------
# Serving: cache, prefill, decode and mixed steps
# ---------------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, *, paged: bool = False,
                page_size: int = 64, num_pages: int | None = None,
                kv_quant: str = "off"):
    """The CacheSpec registry for this model — one spec per layer."""
    return cache_mod.model_cache_specs(cfg, batch, max_len, dtype,
                                      paged=paged, page_size=page_size,
                                      num_pages=num_pages, kv_quant=kv_quant)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, *, paged: bool = False,
               page_size: int = 64, num_pages: int | None = None,
               kv_quant: str = "off", device=None) -> Params:
    """{"layers": [layer cache, ...]} on ``device`` (the card unless
    ``device="cpu"``).  ``paged=True`` gives every attention layer its own
    page pool of ``num_pages`` pages and a block table (all -1);
    ``kv_quant="int8"|"fp8"`` stores those pools quantized, with f32 row
    scales beside them."""
    dev = resolve_device(device)
    specs = cache_specs(cfg, batch, max_len, dtype, paged=paged,
                        page_size=page_size, num_pages=num_pages,
                        kv_quant=kv_quant)
    return {"layers": [spec.init(dev) for spec in specs["layers"]]}


set_block_tables = cache_mod.set_block_tables
get_block_tables = cache_mod.get_block_tables
copy_pages = cache_mod.copy_pages
copy_pages_across = cache_mod.copy_pages_across
export_pages = cache_mod.export_pages
adopt_pages = cache_mod.adopt_pages


def prefill(p: Params, cfg: ModelConfig, tokens, cache: Params,
            impl: str = "kernel", lengths=None
            ) -> tuple[torch.Tensor, Params]:
    """Uniform-length prompt [B, P] -> (last-position logits [B, V], cache).

    ``lengths`` (i32[B]) admits a ragged right-padded batch: row b's prompt
    is tokens[b, :lengths[b]], logits come from its last valid position,
    and rows with ``lengths[b] == 0`` keep their cache (output garbage).
    Prefill attention is the plain matmul path on every device (no kernel
    of this slice serves it), so ``impl`` is accepted for symmetry only.
    """
    _check_supported(cfg)
    dev = p["embed"]["w"].device
    tokens = _tokens(tokens, dev)
    if lengths is not None:
        lengths = _tokens(lengths, dev)
    x = _embed(p, cfg, tokens)
    ctx = _make_ctx(cfg, x.shape[1], dev, lengths=lengths)
    ctx = ctx._replace(mode="prefill", impl=impl)
    x, cache = _run_blocks(p, cfg, x, ctx, cache)
    if lengths is not None:
        last = (lengths.long() - 1).clamp(min=0)
        x = x[torch.arange(x.shape[0], device=dev), last][:, None]
    else:
        x = x[:, -1:]
    return _final(p, cfg, x)[:, 0], cache


def decode_step(p: Params, cfg: ModelConfig, token, cache: Params, pos,
                impl: str = "kernel") -> tuple[torch.Tensor, Params]:
    """token: i32[B]; pos: i32[B] cache fill -> (logits [B, V], cache)."""
    _check_supported(cfg)
    dev = p["embed"]["w"].device
    token, pos = _tokens(token, dev), _tokens(pos, dev)
    x = _embed(p, cfg, token[:, None])
    ctx = BlockCtx(positions=pos[:, None], mask_full=None, mode="decode",
                   pos=pos, impl=impl)
    x, cache = _run_blocks(p, cfg, x, ctx, cache)
    return _final(p, cfg, x)[:, 0], cache


def mixed_step(p: Params, cfg: ModelConfig, tokens, cache: Params, start,
               span, impl: str = "kernel", all_logits: bool = False
               ) -> tuple[torch.Tensor, Params]:
    """Token-budget mixed step: per-row query spans in one batched call.

    tokens: i32[B, C] right-padded span tokens; start: i32[B] tokens already
    cached per row; span: i32[B] valid new tokens in [0, C].  Returns
    (logits [B, V] at each row's last valid span position, cache); span-0
    rows' logits are garbage.  ``all_logits`` returns [B, C, V].
    """
    _check_supported(cfg)
    if ("local" in cache_mod.layer_kinds(cfg) and cfg.ring_local_cache
            and cfg.window):
        # A ring cache wraps under multi-token spans: a later span token can
        # overwrite a slot an earlier query's window still needs.  Windowed
        # layers over an unbounded dense cache are fine (the masks hold the
        # window).
        raise NotImplementedError(
            "mixed step over a ring local cache is unsupported — disable "
            "ring_local_cache (dense windowed cache) to serve chunked")
    dev = p["embed"]["w"].device
    tokens = _tokens(tokens, dev)
    start, span = _tokens(start, dev), _tokens(span, dev)
    b, c = tokens.shape
    x = _embed(p, cfg, tokens)
    positions = start[:, None] + torch.arange(c, dtype=start.dtype,
                                              device=dev)[None, :]
    ctx = BlockCtx(positions=positions, mask_full=None, mode="mixed",
                   pos=start, impl=impl, lengths=span)
    x, cache = _run_blocks(p, cfg, x, ctx, cache)
    if all_logits:
        return _final(p, cfg, x), cache
    last = (span.long() - 1).clamp(min=0)
    x = x[torch.arange(b, device=dev), last][:, None]
    return _final(p, cfg, x)[:, 0], cache


# ---------------------------------------------------------------------------
# Recurrent state rows (state-layout layers)
# ---------------------------------------------------------------------------

def state_layers(cfg: ModelConfig) -> list[int]:
    """Indices of the layers whose cache is the ``state`` layout."""
    return [i for i, kind in enumerate(cache_mod.layer_kinds(cfg))
            if cache_mod.layout_for(kind, cfg, paged=False) == "state"]


def _blend(mask: torch.Tensor, new: dict, old: dict) -> dict:
    """Per leaf: ``new`` (cast to the live dtype) where ``mask[b]``."""
    out = {}
    for name, o in old.items():
        m = mask.to(o.device).reshape((-1,) + (1,) * (o.dim() - 1))
        out[name] = torch.where(m, new[name].to(o.device, o.dtype), o)
    return out


def reset_state_rows(cfg: ModelConfig, cache: Params, mask) -> Params:
    """Reset recurrent (state-layout) layers to fresh init for rows where
    ``mask`` is True: a freed row must not leak its h / conv state into the
    next admitted request.  Attention caches need no reset: their writes
    overwrite and their reads are position-bounded."""
    mask = torch.as_tensor(mask, dtype=torch.bool)
    batch = int(mask.shape[0])
    layers = list(cache["layers"])
    for i in state_layers(cfg):
        kind = cache_mod.layer_kinds(cfg)[i]
        fresh = cache_mod.spec_for(kind, cfg, batch, 1).init(
            layers[i]["h"].device)
        layers[i] = _blend(mask, fresh, layers[i])
    return dict(cache, layers=layers)


def snapshot_state_rows(cfg: ModelConfig, cache: Params) -> Params:
    """Copies of the recurrent carries: ``{"layers": [copy or None]}``, the
    whole-row half of a speculative-decoding rollback snapshot."""
    state = set(state_layers(cfg))
    return {"layers": [{k: t.clone() for k, t in layer.items()}
                       if i in state else None
                       for i, layer in enumerate(cache["layers"])]}


def restore_state_rows(cfg: ModelConfig, cache: Params, snap: Params,
                       mask) -> Params:
    """Blend ``snap`` (from :func:`snapshot_state_rows`) back into the rows
    where ``mask`` is True: a recurrent carry folds every span token
    irreversibly, so a rollback restores the pre-verify carry and the
    caller replays the committed prefix."""
    mask = torch.as_tensor(mask, dtype=torch.bool)
    layers = list(cache["layers"])
    for i in state_layers(cfg):
        layers[i] = _blend(mask, snap["layers"][i], layers[i])
    return dict(cache, layers=layers)
