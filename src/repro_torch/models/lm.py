"""Top-level language model: embedding → blocks → head (tied or not).

Parameters are a dict ``{"embed": {"w"}, "final_norm": {...}, "layers":
[block params per layer], ("head": {"w"}), ("encoder": {"pos", "blocks":
[...], "norm"})}`` with the JAX tree's leaf names and layouts; where JAX
stacks each pattern slot's layers (and the encoder's) on a [G] axis for
``lax.scan``, the port keeps one dict per layer and loops over them
(``convert.params_from_jax`` unstacks a JAX tree).  Encoder-decoder models
(whisper) run a bidirectional encoder over stub frame embeddings
(``enc_frames`` on ``forward`` and ``prefill``) on ``flash_attention``.
Prefix-LM models (PaliGemma, ``num_prefix_tokens``) take stub patch
embeddings (``prefix_embeds`` [B, P, d]) ahead of the text: the prefix
attends bidirectionally, the text causally and to the whole prefix.
Prompts past ``CHUNKED_THRESHOLD`` tokens run the blockwise attention path
(``attention._sdpa_chunked``), as JAX's do.

Entry points mirror ``repro.models.lm``: ``forward`` and ``loss_fn``
(training, with ``remat``: each layer checkpointed), ``init_cache``,
``prefill``, ``decode_step``, ``mixed_step``, ``verify_step`` with
``rollback_snapshot`` / ``rollback_restore`` (speculative decoding) and,
for recurrent (``state`` layout) layers, ``reset_state_rows``,
``snapshot_state_rows`` and ``restore_state_rows``.  ``impl="kernel"`` runs the kernels where the
tensors live (the Hopper kernels on the card, the plain versions on the
CPU); ``impl="ref"`` takes the plain versions.  Attention caches are
updated in place; recurrent layers hand back new state tensors.
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.models import blocks, common
from repro_torch.models import cache as cache_mod
from repro_torch.models.blocks import BlockCtx
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import activation

Params = Any

CHUNKED_THRESHOLD = 8192


def _check_supported(cfg: ModelConfig) -> None:
    for kind in set(cache_mod.layer_kinds(cfg)):
        blocks.check_kind(kind)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init(cfg: ModelConfig, *, seed: int = 0, device=None) -> Params:
    """Random bf16 weights from a seeded ``torch.Generator`` on ``device``
    (the card unless ``device="cpu"``).  The draws are the port's own: for
    the JAX reference's weights use ``convert.params_from_jax``."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = (_MetaGenerator() if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
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
    if cfg.is_encdec:
        e = cfg.encoder
        p["encoder"] = {
            "pos": (torch.randn((e.seq_len, d), generator=gen, device=dev)
                    * 0.02).to(common.PARAM_DTYPE),
            "blocks": [blocks.block_init("attn", gen, cfg)
                       for _ in range(e.num_layers)],
            "norm": common.norm_init(d, cfg.norm_type, dev),
        }
    return p


class _MetaGenerator(torch.Generator):
    """A generator that reports the ``meta`` device, which has none of its
    own: the draws of ``init`` on ``meta`` tensors read no state."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def abstract_params(cfg: ModelConfig) -> Params:
    """The tree ``init`` makes, as ``meta`` tensors: every leaf's shape
    and dtype with nothing allocated (the dry run's parameters)."""
    return init(cfg, device="meta")


@contextlib.contextmanager
def unrolled_scans():
    """Kept for JAX's name, and does nothing.  JAX's dry run unrolls its
    layer-group ``lax.scan``s under it, because XLA's cost analysis counts
    a scan body once.  The port has no scan: it keeps one module a layer
    and loops over them in Python, so every layer's operations are counted
    as they run."""
    yield


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def _embed(p: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    # ``embedding``, not an index: on a vocab-sharded table (a sharded
    # run) each rank looks up the rows it holds and the partial rows are
    # summed, as GSPMD partitions the gather; the table is never gathered.
    x = torch.nn.functional.embedding(
        tokens.long(), activation.fsdp_gathered(p["embed"]["w"]))
    # The partial rows summed once, whole on every model rank (before the
    # residual stream's two readers).
    x = activation.constrain(x, "batch", None, None)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _head(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = activation.matmul(x, p["embed"]["w"].t().to(x.dtype))
    else:
        logits = common.dense(p["head"], x)
    # Logits stay vocab-sharded through the float32 loss under a binding.
    logits = activation.constrain(logits, "batch", None, "vocab")
    return common.softcap(logits.float(), cfg.logit_softcap)


def _tokens(tokens, device) -> torch.Tensor:
    return torch.as_tensor(tokens, device=device)


def _encode(p: Params, cfg: ModelConfig, enc_frames: torch.Tensor,
            impl: str) -> torch.Tensor:
    """Bidirectional encoder over stub frame embeddings [B, Te, d]: the
    frames plus the positional table in the frames' dtype, the encoder's
    ``attn`` blocks with no mask and no window (on ``flash_attention``
    with ``causal=False`` unless ``impl="ref"``; JAX's heads are the
    decoder's, ``encoder.num_heads`` goes unused), then its norm."""
    e = p["encoder"]
    x = enc_frames + e["pos"].to(enc_frames.dtype)[None]
    ctx = BlockCtx(positions=torch.arange(x.shape[1], device=x.device),
                   mask_full=None, mode="full", impl=impl, causal=False)
    ecfg = cfg.replace(window=None)
    for bp in e["blocks"]:
        x, _, _ = blocks.block_apply("attn", bp, ecfg, x, ctx, None)
    return common.apply_norm(e["norm"], x, cfg.norm_type, cfg.norm_eps)


def _enc_out(p: Params, cfg: ModelConfig, enc_frames, impl: str, device
             ) -> Optional[torch.Tensor]:
    """The encoder's output for an encoder-decoder model, else None."""
    if not cfg.is_encdec:
        return None
    if enc_frames is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder model: pass "
                         f"enc_frames [B, {cfg.encoder.seq_len}, "
                         f"{cfg.d_model}]")
    return _encode(p, cfg, torch.as_tensor(enc_frames, device=device), impl)


def _make_ctx(cfg: ModelConfig, t: int, device, prefix_len: int = 0,
              lengths: Optional[torch.Tensor] = None) -> BlockCtx:
    if t > CHUNKED_THRESHOLD:
        if lengths is not None:
            raise NotImplementedError(
                "ragged prefill above the chunked-attention threshold")
        # Long sequences: masks built a tile at a time inside the blockwise
        # online-softmax attention (T×T masks and scores would be GiB).
        return BlockCtx(positions=torch.arange(t, device=device),
                        mask_full=None, mode="full", chunked=True,
                        prefix_len=prefix_len)
    mask_full = common.make_mask(t, t, causal=True, prefix_len=prefix_len,
                                 device=device)
    mask_local = (common.make_mask(t, t, causal=True, window=cfg.window,
                                   prefix_len=prefix_len, device=device)
                  if "local" in cfg.block_pattern else None)
    if lengths is not None:
        valid = (torch.arange(t, device=device)[None, :]
                 < lengths[:, None])                            # [B, T]
        mask_full = mask_full[None] & valid[:, None, :]
        if mask_local is not None:
            mask_local = mask_local[None] & valid[:, None, :]
    return BlockCtx(positions=torch.arange(t, device=device),
                    mask_full=mask_full, mode="full", lengths=lengths,
                    mask_local=mask_local, prefix_len=prefix_len)


def _checkpointed(kind: str, lp: Params, cfg: ModelConfig, x: torch.Tensor,
                  ctx: BlockCtx) -> tuple[torch.Tensor, None, torch.Tensor]:
    """One cache-free layer whose activations the backward pass recomputes
    (``torch.utils.checkpoint``, non-reentrant: the layer's parameters
    reach it by closure and still get their gradients)."""
    def layer(y):
        y, _, a = blocks.block_apply(kind, lp, cfg, y, ctx, None)
        return y, (torch.zeros((), dtype=torch.float32, device=y.device)
                   if a is None else a)
    y, a = torch.utils.checkpoint.checkpoint(layer, x, use_reentrant=False)
    return y, None, a


def _run_blocks(p: Params, cfg: ModelConfig, x: torch.Tensor,
                ctx: BlockCtx, cache: Params | None, remat: bool = False
                ) -> tuple[torch.Tensor, Params | None, torch.Tensor]:
    """Every layer in order: (x, the new cache or None, the layers' aux
    losses summed, a float32 scalar: 0 without an MoE layer).

    ``remat=True`` (training, ``cache`` None) checkpoints each layer: its
    activations are recomputed in the backward pass, where JAX's
    ``jax.checkpoint`` recomputes each scanned group."""
    kinds = cache_mod.layer_kinds(cfg)
    layers = cache["layers"] if cache is not None else [None] * len(kinds)
    new_layers = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, lp, lc in zip(kinds, p["layers"], layers):
        if cache is None:
            # The sequence-parallel residual stream between layers.
            x = activation.constrain(x, "batch", "seq", None)
        if remat and cache is None:
            x, lc, a = _checkpointed(kind, lp, cfg, x, ctx)
        else:
            x, lc, a = blocks.block_apply(kind, lp, cfg, x, ctx, lc)
        new_layers.append(lc)
        if a is not None:
            aux = aux + a
    if cache is None:
        return x, None, aux
    return x, dict(cache, layers=new_layers), aux


def _final(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = common.apply_norm(p["final_norm"], x, cfg.norm_type, cfg.norm_eps)
    return _head(p, cfg, x)


def _with_prefix(cfg: ModelConfig, x: torch.Tensor, prefix_embeds
                 ) -> tuple[torch.Tensor, int]:
    """(the block input, prefix_len): a prefix-LM's stub embeddings
    [B, P, d] ahead of the embedded text, in its dtype and unscaled by
    ``embed_scale``, as in JAX; without either the text alone."""
    if not cfg.num_prefix_tokens or prefix_embeds is None:
        return x, 0
    pre = torch.as_tensor(prefix_embeds, device=x.device).to(x.dtype)
    return torch.cat([pre, x], dim=1), cfg.num_prefix_tokens


# ---------------------------------------------------------------------------
# Full-sequence forward
# ---------------------------------------------------------------------------

def forward(p: Params, cfg: ModelConfig, tokens, prefix_embeds=None,
            enc_frames=None, impl: str = "kernel", remat: bool = False
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens: [B, Tt] -> (logits [B, T, V] float32, aux loss: the MoE
    layers' load-balancing losses summed, 0 without one).  T is Tt, plus
    P for a prefix-LM given ``prefix_embeds`` [B, P, d] (the logits cover
    prefix and text).  ``enc_frames`` [B, Te, d]: an encoder-decoder
    model's encoder input.  ``remat=True`` recomputes each layer's
    activations in the backward pass.

    The kernels have no backward (in either package): a loss differentiated
    through ``impl="kernel"`` on the card raises in the kernel wrappers;
    training runs ``impl="ref"`` (:func:`loss_fn`'s default)."""
    _check_supported(cfg)
    dev = p["embed"]["w"].device
    tokens = _tokens(tokens, dev)
    x, prefix_len = _with_prefix(cfg, _embed(p, cfg, tokens), prefix_embeds)
    ctx = _make_ctx(cfg, x.shape[1], dev, prefix_len)._replace(
        impl=impl, enc_out=_enc_out(p, cfg, enc_frames, impl, dev))
    x, _, aux = _run_blocks(p, cfg, x, ctx, None, remat=remat)
    return _final(p, cfg, x), aux


def loss_fn(p: Params, cfg: ModelConfig, batch: dict, impl: str = "ref",
            aux_weight: float = 0.01, remat: bool = False
            ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """batch: tokens [B, T], targets [B, T], loss_mask f32[B, T] (+ the
    stub inputs ``prefix_embeds`` / ``enc_frames``), tensors or numpy.

    Returns (xent + ``aux_weight`` · aux, {"xent", "moe_aux", "tokens"}):
    the mean next-token cross-entropy over the masked positions (prefix
    positions carry none: the last T logits are scored), float32."""
    dev = p["embed"]["w"].device
    logits, aux = forward(
        p, cfg, batch["tokens"], prefix_embeds=batch.get("prefix_embeds"),
        enc_frames=batch.get("enc_frames"), impl=impl, remat=remat)
    logits = logits[:, -batch["tokens"].shape[1]:]
    logp = torch.log_softmax(logits, dim=-1)
    tgt = _tokens(batch["targets"], dev).long()
    tgt = torch.gather(logp, -1, tgt[..., None])[..., 0]
    mask = _tokens(batch["loss_mask"], dev).float()
    denom = torch.clamp(mask.sum(), min=1.0)
    xent = -(tgt * mask).sum() / denom
    total = xent + aux_weight * aux
    return total, {"xent": xent, "moe_aux": aux, "tokens": mask.sum()}


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
            prefix_embeds=None, enc_frames=None, impl: str = "kernel",
            lengths=None) -> tuple[torch.Tensor, Params]:
    """Uniform-length prompt [B, P] -> (last-position logits [B, V], cache).

    ``lengths`` (i32[B]) admits a ragged right-padded batch: row b's prompt
    is tokens[b, :lengths[b]], logits come from its last valid position,
    and rows with ``lengths[b] == 0`` keep their cache (output garbage).
    The prompt's attention is the plain masked matmul path on every device,
    blockwise past ``CHUNKED_THRESHOLD`` tokens; ``impl`` reaches an
    encoder-decoder model's encoder (``enc_frames`` [B, Te, d], on
    ``flash_attention``), whose output fills the cross-KV.  A prefix-LM's
    ``prefix_embeds`` [B, Pp, d] go ahead of the prompt and fill cache
    positions [0, Pp); the prompt follows them.
    """
    _check_supported(cfg)
    if lengths is not None and (cfg.num_prefix_tokens or cfg.is_encdec):
        raise NotImplementedError(
            f"ragged prefill supports decoder-only patterns without "
            f"prefix/encoder inputs, got {cfg.block_pattern}")
    dev = p["embed"]["w"].device
    tokens = _tokens(tokens, dev)
    if lengths is not None:
        lengths = _tokens(lengths, dev)
    x, prefix_len = _with_prefix(cfg, _embed(p, cfg, tokens), prefix_embeds)
    ctx = _make_ctx(cfg, x.shape[1], dev, prefix_len, lengths=lengths)
    ctx = ctx._replace(mode="prefill", impl=impl,
                       enc_out=_enc_out(p, cfg, enc_frames, impl, dev))
    x, cache, _ = _run_blocks(p, cfg, x, ctx, cache)
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
    x, cache, _ = _run_blocks(p, cfg, x, ctx, cache)
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
    if cfg.num_prefix_tokens or cfg.is_encdec:
        raise NotImplementedError(
            f"mixed step supports decoder-only patterns without prefix or "
            f"encoder inputs, got {cfg.block_pattern}")
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
    x, cache, _ = _run_blocks(p, cfg, x, ctx, cache)
    if all_logits:
        return _final(p, cfg, x), cache
    last = (span.long() - 1).clamp(min=0)
    x = x[torch.arange(b, device=dev), last][:, None]
    return _final(p, cfg, x)[:, 0], cache


def verify_step(p: Params, cfg: ModelConfig, tokens, cache: Params, start,
                span, impl: str = "kernel"
                ) -> tuple[torch.Tensor, torch.Tensor, Params]:
    """Speculative-decoding verify: one all-logits mixed step plus per-row
    greedy accept counts.

    ``tokens[b] = [last_committed, d_1 .. d_m, pad]`` with ``span = 1 + m``
    (plain decode and admission rows ride along with their usual spans and
    count 0).  Returns (preds i32[B, C], the argmax after every span
    position; accepted i32[B], the longest accepted draft prefix per
    ``kernels.ref.speculative_accept``; cache).  The cache then holds the
    whole span's writes: the caller commits up to its accept point and
    rolls the rejected tail back with ``cache.snapshot_span`` /
    ``restore_span`` (and ``restore_state_rows`` plus a replay of the
    committed span for recurrent layers).
    """
    from repro_torch.kernels import ref as kref
    logits, cache = mixed_step(p, cfg, tokens, cache, start, span, impl=impl,
                               all_logits=True)
    preds = torch.argmax(logits, dim=-1).to(torch.int32)
    dev = preds.device
    accepted = kref.speculative_accept(preds, _tokens(tokens, dev),
                                       _tokens(span, dev))
    return preds, accepted, cache


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
    ``mask`` is True: a freed row must not leak its carry into the next
    admitted request.  Attention caches need no reset: their writes
    overwrite and their reads are position-bounded."""
    mask = torch.as_tensor(mask, dtype=torch.bool)
    batch = int(mask.shape[0])
    layers = list(cache["layers"])
    for i in state_layers(cfg):
        kind = cache_mod.layer_kinds(cfg)[i]
        fresh = cache_mod.spec_for(kind, cfg, batch, 1).init(
            next(iter(layers[i].values())).device)
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


def rollback_snapshot(cfg: ModelConfig, cache: Params, start,
                      width: int) -> Params:
    """The speculative-decoding rollback snapshot, taken before a verify
    step: copies of the slots a span of ``width`` at ``start`` may write
    (``cache.snapshot_span``) and, for recurrent layers, of the carries
    (:func:`snapshot_state_rows`)."""
    snap = {"spans": cache_mod.snapshot_span(cache, start, width)}
    if state_layers(cfg):
        snap["state"] = snapshot_state_rows(cfg, cache)
    return snap


def rollback_restore(cfg: ModelConfig, cache: Params, snap: Params, start,
                     lo, hi, mask) -> Params:
    """Roll a verify step's rejected tails back from ``snap``: positions
    [lo[b], hi[b]) get their pre-verify bytes (``cache.restore_span``),
    and the rows in ``mask`` their pre-verify carries; the caller replays
    the committed tokens through the recurrent layers."""
    cache = cache_mod.restore_span(cache, snap["spans"], start, lo, hi)
    if "state" in snap:
        cache = restore_state_rows(cfg, cache, snap["state"], mask)
    return cache

