"""Serving engine: prefill/decode/mixed step functions and the host-side
generation loop.

The step factories mirror ``repro.serving.engine``.  JAX jits each step and
compiles it once per width bucket; the port runs them eagerly (a CUDA graph
per bucket is a later, measured change), so ``width_bucket`` only bounds
the set of shapes the kernels see.  Sampling at temperature > 0 draws from
an explicit ``torch.Generator``; greedy decoding needs none.

``make_gossip_fns`` is the delta-sync triple the replicated page table's
host gossip runs (``serving/replicated.py``, the simulator).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core import delta as delta_mod
from repro_torch.models import attention, lm
from repro_torch.models.config import ModelConfig

Params = Any


def sample_token(logits: torch.Tensor, gen: Optional[torch.Generator],
                 temperature: float = 0.0) -> torch.Tensor:
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if gen is None:
        raise ValueError("temperature > 0 requires a torch.Generator")
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


def make_serve_step(cfg: ModelConfig, *, impl: str = "kernel",
                    temperature: float = 0.0):
    """(params, cache, token[B], pos[B], gen) -> (next_token, cache, pos+1)."""

    def serve_step(params, cache, token, pos, gen=None):
        logits, cache = lm.decode_step(params, cfg, token, cache, pos,
                                       impl=impl)
        return sample_token(logits, gen, temperature), cache, pos + 1

    return serve_step


def make_prefill_fn(cfg: ModelConfig, *, impl: str = "kernel"):
    def prefill_fn(params, cache, tokens):
        return lm.prefill(params, cfg, tokens, cache, impl=impl)

    return prefill_fn


def make_ragged_prefill_fn(cfg: ModelConfig, *, impl: str = "kernel"):
    """(params, cache, tokens [B, P], lengths i32[B]) -> (logits, cache).

    Rows with ``lengths[b] == 0`` keep their cache: the one-shot oracle the
    mixed step is checked against (serving admits prompts chunk by chunk
    through ``make_mixed_step_fn``)."""
    def prefill_fn(params, cache, tokens, lengths):
        return lm.prefill(params, cfg, tokens, cache, impl=impl,
                          lengths=lengths)

    return prefill_fn


PROMPT_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024)


def bucket_len(n: int, buckets=PROMPT_BUCKETS, max_len: Optional[int] = None
               ) -> int:
    """Smallest bucket >= n; ``max_len`` clamps (checked before raising)."""
    if max_len is not None and n > max_len:
        raise ValueError(f"prompt length {n} exceeds max_len {max_len}")
    for b in buckets:
        if n <= b:
            return b if max_len is None else min(b, max_len)
    if max_len is not None:
        return max_len
    raise ValueError(f"prompt length {n} exceeds largest bucket {buckets[-1]}")


def make_mixed_step_fn(cfg: ModelConfig, *, impl: str = "kernel",
                       temperature: float = 0.0):
    """(params, cache, tokens [B, C], start [B], span [B], gen)
    -> (next_token [B], cache): every row spends its span in one call
    (1 token decoding, a prompt chunk admitting, 0 idle); ``next_token``
    comes from each row's last valid span position."""
    def mixed_step(params, cache, tokens, start, span, gen=None):
        logits, cache = lm.mixed_step(params, cfg, tokens, cache, start,
                                      span, impl=impl)
        return sample_token(logits, gen, temperature), cache

    return mixed_step


def width_bucket(n: int, chunk: int) -> int:
    """Smallest power of two >= n, clamped to ``chunk``."""
    n = max(1, min(n, chunk))
    return min(1 << (n - 1).bit_length(), chunk)


def mixed_width_buckets(chunk: int) -> tuple[int, ...]:
    """Every width ``width_bucket`` can produce for spans in [1, chunk]."""
    out = []
    w = 1
    while w < chunk:
        out.append(w)
        w <<= 1
    out.append(chunk)
    return tuple(out)


def backoff_steps(rid: int, attempt: int, *, base: int = 4,
                  cap: int = 64) -> int:
    """Retry delay (in steps): capped exponential backoff plus a
    deterministic jitter hashed from (rid, attempt)."""
    delay = min(cap, base << max(0, attempt - 1))
    h = (rid * 0x9E3779B1 + attempt * 0x85EBCA77) & 0xFFFFFFFF
    h ^= h >> 16
    return delay + h % max(1, delay // 2)


class GossipFns:
    """Delta-sync triple for host-side replica gossip: the genesis frontier
    of a CRDT state template, ``extract`` and ``apply``.

    The host analogue of the fused step's in-mesh delta ring: host-level
    replicas (multi-engine serving, the replica simulator) gossip frontiers
    and deltas over an explicit — possibly faulty — channel.  JAX jits the
    pair once per template; here they run eagerly on the template's device
    (the CPU for the replicated page table).
    """

    def __init__(self, template: Any, capacity: Any):
        self.capacity = capacity
        self.genesis = delta_mod.frontier(template)

    def extract(self, state: Any, frontier: Any) -> tuple[Any, Any]:
        """(delta beyond ``frontier``, frontier actually shipped)."""
        return delta_mod.extract(state, frontier, self.capacity)

    def apply(self, state: Any, delta: Any) -> Any:
        return delta_mod.apply(state, delta)


def make_gossip_fns(template: Any, capacity: Any = 32) -> GossipFns:
    """The (genesis frontier, extract, apply) gossip triple for a CRDT
    state template (any registered type or dict container); ``capacity``
    is an int or ``(key, cap)`` pairs with a ``"*"`` default."""
    return GossipFns(template, capacity)


class Engine:
    """Single-process serving engine: prefill a uniform prompt batch, then
    decode one token per row per step.  Rows carry per-row positions."""

    def __init__(self, cfg: ModelConfig, params: Params, *, batch: int,
                 max_len: int, impl: str = "kernel",
                 temperature: float = 0.0, paged: bool = False,
                 page_size: int = 64, seed: int = 0, device=None):
        self.device = resolve_device(device)
        if params["embed"]["w"].device != self.device:
            raise ValueError(f"params live on {params['embed']['w'].device},"
                             f" the engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.batch = batch
        self.max_len = max_len
        self.paged = paged
        self.page_size = page_size
        self.seed = seed
        self._prefill = make_prefill_fn(cfg, impl=impl)
        self._step = make_serve_step(cfg, impl=impl, temperature=temperature)
        self.reset()

    def reset(self):
        self.cache = lm.init_cache(self.cfg, self.batch, self.max_len,
                                   paged=self.paged,
                                   page_size=self.page_size,
                                   device=self.device)
        if self.paged:
            self.cache = lm.set_block_tables(
                self.cache, attention.default_block_tables(
                    self.batch, self.max_len, self.page_size, self.device))
        self.pos = torch.zeros((self.batch,), dtype=torch.int32,
                               device=self.device)
        self.token = torch.zeros((self.batch,), dtype=torch.int32,
                                 device=self.device)
        self.gen = torch.Generator(device=self.device).manual_seed(self.seed)
        # Host mirror of max(pos): the paged-full guard must not force a
        # device sync per step.
        self._pos_ceiling = 0

    def prefill(self, tokens) -> torch.Tensor:
        """Uniform prompt for all rows. tokens: [B, P]."""
        tokens = torch.as_tensor(tokens, device=self.device)
        logits, self.cache = self._prefill(self.params, self.cache, tokens)
        self.pos = torch.full((self.batch,), tokens.shape[1],
                              dtype=torch.int32, device=self.device)
        self._pos_ceiling = tokens.shape[1]
        self.token = torch.argmax(logits, dim=-1).to(torch.int32)
        return self.token

    def step(self) -> torch.Tensor:
        if self.paged and self._pos_ceiling >= self.max_len:
            raise ValueError(
                f"paged cache is full (pos {self._pos_ceiling} >= max_len "
                f"{self.max_len}); a dense cache ring-wraps, pages do not — "
                "bound generation or raise max_len")
        self.token, self.cache, self.pos = self._step(
            self.params, self.cache, self.token, self.pos, self.gen)
        self._pos_ceiling += 1
        return self.token

    def generate(self, tokens, steps: int) -> torch.Tensor:
        outs = [self.prefill(tokens)]
        for _ in range(steps - 1):
            outs.append(self.step())
        return torch.stack(outs, dim=1)
