"""Last-writer-wins register bank — the array-backed analogue of Yjs Y.Map.

A bank holds ``K`` registers.  Each carries a Lamport ``(clock, client)``
pair plus a dict of payload tensors, all shaped ``[K, ...]``.  The merge is
the join of the total order on ``(clock, client)`` — commutative,
associative and idempotent.  A well-behaved client never reuses a clock, so
the winner's payload is well defined.

The standalone ``lww_merge`` TPU kernel (``repro/kernels/lww_merge.py``) is
not ported yet (ROADMAP.md queue 2 item 10); this tensor code is the
semantic path, as the jnp join is in the JAX package.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.core.clock import i32, pack_key


class LWWBank(NamedTuple):
    clock: torch.Tensor     # i32[K]   0 = never written
    client: torch.Tensor    # i32[K]   0 = never written
    payload: Any            # dict of tensors, each [K, ...]

    @property
    def key(self) -> torch.Tensor:
        return pack_key(self.clock, self.client)

    @property
    def written(self) -> torch.Tensor:
        return self.clock > 0


def empty(num_keys: int, payload_spec: dict[str, tuple[tuple[int, ...], Any]],
          device=None) -> LWWBank:
    """payload_spec: field -> (trailing_shape, torch dtype)."""
    dev = resolve_device(device)
    payload = {name: torch.zeros((num_keys, *shape), dtype=dtype, device=dev)
               for name, (shape, dtype) in payload_spec.items()}
    return LWWBank(clock=torch.zeros((num_keys,), dtype=torch.int32,
                                     device=dev),
                   client=torch.zeros((num_keys,), dtype=torch.int32,
                                      device=dev),
                   payload=payload)


def _expand(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (ndim - mask.dim()))


def write(bank: LWWBank, key, clock, client, **fields) -> LWWBank:
    """Local write: set register ``key`` if (clock, client) beats current.

    A stale writer's write is dropped (LWW semantics)."""
    k = int(key)
    dev = bank.clock.device
    clock, client = i32(clock, dev), i32(client, dev)
    wins = pack_key(clock, client) > bank.key[k]
    payload = dict(bank.payload)
    for name, value in fields.items():
        cur = bank.payload[name]
        val = torch.as_tensor(value, device=dev).to(cur.dtype)
        new = cur.clone()
        new[k] = torch.where(wins, val, cur[k])
        payload[name] = new
    new_clock, new_client = bank.clock.clone(), bank.client.clone()
    new_clock[k] = torch.where(wins, clock, bank.clock[k])
    new_client[k] = torch.where(wins, client, bank.client[k])
    return LWWBank(clock=new_clock, client=new_client, payload=payload)


def write_masked(bank: LWWBank, mask: torch.Tensor, clock, client,
                 **fields) -> LWWBank:
    """Vectorized write to every register where ``mask`` (bool[K]) holds."""
    dev = bank.clock.device
    clock = i32(clock, dev).expand(mask.shape)
    client = i32(client, dev).expand(mask.shape)
    wins = mask & (pack_key(clock, client) > bank.key)
    payload = dict(bank.payload)
    for name, value in fields.items():
        cur = bank.payload[name]
        val = torch.as_tensor(value, device=dev).to(cur.dtype).expand(
            cur.shape)
        payload[name] = torch.where(_expand(wins, cur.dim()), val, cur)
    return LWWBank(clock=torch.where(wins, clock, bank.clock),
                   client=torch.where(wins, client, bank.client),
                   payload=payload)


def merge(a: LWWBank, b: LWWBank) -> LWWBank:
    """Join: per-register lexicographic max of (clock, client); winner's
    payload."""
    b_wins = b.key > a.key
    payload = {name: torch.where(_expand(b_wins, av.dim()), b.payload[name],
                                 av)
               for name, av in a.payload.items()}
    return LWWBank(clock=torch.where(b_wins, b.clock, a.clock),
                   client=torch.where(b_wins, b.client, a.client),
                   payload=payload)


def read(bank: LWWBank, field: str, key) -> torch.Tensor:
    return bank.payload[field][key]
