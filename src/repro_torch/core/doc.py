"""SlotDoc: the production-path shared code document.

The outliner's skeleton fixes an ordered set of K regions (one per TODO).
After a TODO is claimed, exactly one agent appends tokens into its region,
so each region is a single-writer append-only buffer and the document is
the in-order concatenation of regions.  The join is exact (lengths: max;
tokens: identical where observed), so character-level convergence is
structural; semantic conflicts (duplicate declarations across regions) are
found by the evaluator agent.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.core.clock import i32

_U32 = 0xFFFFFFFF


class SlotDoc(NamedTuple):
    tokens: torch.Tensor    # i32[K, S]
    length: torch.Tensor    # i32[K]   monotone, owner-only writes
    owner: torch.Tensor     # i32[K]   informational (set by claim winner)

    @property
    def num_slots(self) -> int:
        return self.tokens.shape[0]

    @property
    def slot_capacity(self) -> int:
        return self.tokens.shape[1]

    @property
    def version(self) -> torch.Tensor:
        """Per-slot content version — observation-driven invalidation key."""
        return self.length


def empty(num_slots: int, slot_capacity: int, device=None) -> SlotDoc:
    dev = resolve_device(device)
    return SlotDoc(
        tokens=torch.zeros((num_slots, slot_capacity), dtype=torch.int32,
                           device=dev),
        length=torch.zeros((num_slots,), dtype=torch.int32, device=dev),
        owner=torch.zeros((num_slots,), dtype=torch.int32, device=dev))


def set_owner(doc: SlotDoc, slot, agent) -> SlotDoc:
    s = int(slot)
    owner = doc.owner.clone()
    owner[s] = torch.maximum(owner[s], i32(agent, owner.device))
    return doc._replace(owner=owner)


def append(doc: SlotDoc, slot, tokens: torch.Tensor, length) -> SlotDoc:
    """Owner appends ``length`` tokens (from a fixed-size staging buffer).

    The slot index and the staging length are host values; the slot's fill
    is read on the device, so the append is one device-side update."""
    run_cap = tokens.shape[0]
    s = int(slot)
    dev = doc.tokens.device
    pos0 = doc.length[s]
    n = torch.minimum(i32(length, dev),
                      (doc.slot_capacity - pos0).clamp(0, run_cap))
    # Slot position p takes run token p - pos0 where that offset is in the
    # run; every other position keeps its value.
    off = torch.arange(doc.slot_capacity, dtype=torch.int32,
                       device=dev) - pos0
    in_run = (off >= 0) & (off < n)
    src = i32(tokens, dev)[off.clamp(0, run_cap - 1).long()]
    new_tokens = doc.tokens.clone()
    new_tokens[s] = torch.where(in_run, src, doc.tokens[s])
    new_length = doc.length.clone()
    new_length[s] += n
    return doc._replace(tokens=new_tokens, length=new_length)


def append_token(doc: SlotDoc, slot, token) -> SlotDoc:
    """One-token append (the per-decode-step fused path)."""
    s = int(slot)
    dev = doc.tokens.device
    ok = doc.length[s] < doc.slot_capacity
    pos = doc.length[s].clamp(max=doc.slot_capacity - 1).long()
    tokens = doc.tokens.clone()
    tokens[s, pos] = torch.where(ok, i32(token, dev), doc.tokens[s, pos])
    length = doc.length.clone()
    length[s] += ok.to(torch.int32)
    return doc._replace(tokens=tokens, length=length)


def append_token_batch(doc: SlotDoc, slots: torch.Tensor,
                       tokens: torch.Tensor, active: torch.Tensor) -> SlotDoc:
    """N agents each append one token to their own slot (vectorized).

    ``slots`` must be distinct where ``active`` — guaranteed by the claim
    protocol's at-most-one-winner invariant."""
    slots = slots.long()
    lens = doc.length[slots]
    pos = lens.clamp(max=doc.slot_capacity - 1).long()
    ok = active & (lens < doc.slot_capacity)
    cur = doc.tokens[slots, pos]
    new_tokens = doc.tokens.clone()
    new_tokens[slots, pos] = torch.where(ok, i32(tokens, cur.device), cur)
    length = doc.length.clone()
    length.index_add_(0, slots, ok.to(torch.int32))
    return doc._replace(tokens=new_tokens, length=length)


def valid_mask(doc: SlotDoc) -> torch.Tensor:
    idx = torch.arange(doc.slot_capacity, dtype=torch.int32,
                       device=doc.tokens.device)[None, :]
    return idx < doc.length[:, None]


def merge(a: SlotDoc, b: SlotDoc) -> SlotDoc:
    mine = valid_mask(a)
    return SlotDoc(tokens=torch.where(mine, a.tokens, b.tokens),
                   length=torch.maximum(a.length, b.length),
                   owner=torch.maximum(a.owner, b.owner))


def render(doc: SlotDoc) -> tuple[torch.Tensor, torch.Tensor]:
    """Flatten to (tokens i32[K*S], total_len): in-slot-order concatenation."""
    K, S = doc.tokens.shape
    mask = valid_mask(doc).reshape(-1)
    flat = doc.tokens.reshape(-1)
    total = mask.sum(dtype=torch.int32)
    # Stable left-pack: valid entries first, original order preserved.
    order = torch.argsort((~mask).to(torch.uint8), stable=True)
    idx = torch.arange(K * S, device=flat.device)
    return torch.where(idx < total, flat[order], -1), total


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64, without leaving
    int64's range: the constant is split into 16-bit halves."""
    lo = x * (c & 0xFFFF)                                  # < 2^48
    hi = ((x * (c >> 16)) & 0xFFFF) << 16                  # mod 2^32
    return (lo + hi) & _U32


def digest(doc: SlotDoc) -> torch.Tensor:
    """Order-sensitive content hash — replicas must agree post-merge.

    The JAX reference computes it in uint32 with wrap-around:
    ``sum((h * 2654435761 + idx * 40503) % (2^31 - 1))`` over valid slots.
    Here every uint32 step is an int64 operation masked to 32 bits, so the
    result (an int64 scalar holding the uint32 value) is bitwise the same."""
    mask = valid_mask(doc)
    K, S = doc.tokens.shape
    idx = torch.arange(K * S, dtype=torch.int64,
                       device=doc.tokens.device).reshape(K, S)
    h = torch.where(mask, doc.tokens.to(torch.int64) & _U32, 0)
    mixed = (_mul_u32(h, 2654435761) + _mul_u32(idx & _U32, 40503)) & _U32
    mixed = mixed % (2 ** 31 - 1)
    return torch.where(mask, mixed, 0).sum() & _U32
