"""Grow-only CRDTs: counters, flag sets, and per-client append-only logs.

All three join by an elementwise max (with masking).  ``GLog`` is the
array-backed analogue of Yjs Y.Array: each client owns a row and only ever
appends to it, so the entry at (client, i) is identical on every replica
that has observed it and the join is exact.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.core.clock import i32


class GCounter(NamedTuple):
    counts: torch.Tensor    # i32[C] — per-client monotone count

    @classmethod
    def zeros(cls, num_clients: int, device=None) -> "GCounter":
        return cls(torch.zeros((num_clients,), dtype=torch.int32,
                               device=resolve_device(device)))

    def increment(self, client, amount=1) -> "GCounter":
        c = int(client)
        counts = self.counts.clone()
        counts[c] += i32(amount, counts.device)
        return GCounter(counts)

    def bump_to(self, client, value) -> "GCounter":
        """Monotone set (e.g. heartbeat timestamps)."""
        c = int(client)
        counts = self.counts.clone()
        counts[c] = torch.maximum(counts[c], i32(value, counts.device))
        return GCounter(counts)

    def join(self, other: "GCounter") -> "GCounter":
        return GCounter(torch.maximum(self.counts, other.counts))

    @property
    def value(self) -> torch.Tensor:
        return self.counts.sum(dtype=torch.int32)


class GSet(NamedTuple):
    """Grow-only flag set over a fixed universe of N elements."""

    member: torch.Tensor    # bool[N]

    @classmethod
    def empty(cls, universe: int, device=None) -> "GSet":
        return cls(torch.zeros((universe,), dtype=torch.bool,
                               device=resolve_device(device)))

    def add(self, idx) -> "GSet":
        member = self.member.clone()
        member[int(idx)] = True
        return GSet(member)

    def add_mask(self, mask: torch.Tensor) -> "GSet":
        return GSet(self.member | mask)

    def join(self, other: "GSet") -> "GSet":
        return GSet(self.member | other.member)


class GLog(NamedTuple):
    """Per-client append-only log with arbitrary payload fields."""

    count: torch.Tensor       # i32[C] entries valid at row c are [0, count[c])
    fields: dict[str, Any]    # field -> i32/f32 [C, L, ...]

    @classmethod
    def empty(cls, num_clients: int, capacity: int,
              field_spec: dict[str, tuple[tuple[int, ...], Any]],
              device=None) -> "GLog":
        dev = resolve_device(device)
        fields = {name: torch.zeros((num_clients, capacity, *shape),
                                    dtype=dtype, device=dev)
                  for name, (shape, dtype) in field_spec.items()}
        return cls(count=torch.zeros((num_clients,), dtype=torch.int32,
                                     device=dev), fields=fields)

    @property
    def capacity(self) -> int:
        return next(iter(self.fields.values())).shape[1]

    def append(self, client, **values) -> "GLog":
        """Append one entry to ``client``'s own row (dropped if full)."""
        c = int(client)
        n = int(self.count[c])
        if n >= self.capacity:
            return self
        fields = {}
        for name, arr in self.fields.items():
            new = arr.clone()
            new[c, n] = torch.as_tensor(values[name], device=arr.device).to(
                arr.dtype)
            fields[name] = new
        count = self.count.clone()
        count[c] += 1
        return GLog(count=count, fields=fields)

    def valid_mask(self) -> torch.Tensor:
        """bool[C, L] — which slots hold observed entries."""
        idx = torch.arange(self.capacity, dtype=torch.int32,
                           device=self.count.device)[None, :]
        return idx < self.count[:, None]

    def join(self, other: "GLog") -> "GLog":
        mine = self.valid_mask()
        fields = {}
        for name, arr in self.fields.items():
            m = mine.reshape(mine.shape + (1,) * (arr.dim() - 2))
            fields[name] = torch.where(m, arr, other.fields[name])
        return GLog(count=torch.maximum(self.count, other.count),
                    fields=fields)
