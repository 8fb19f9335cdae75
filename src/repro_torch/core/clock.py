"""Lamport clocks and version vectors.

Clients (agents / workers / pods) are small positive integers
``1 .. MAX_CLIENTS-1``; client 0 means "unset".  Lamport clocks are positive
int32 values bounded by ``MAX_CLOCK`` so that ``(clock, client)`` packs
losslessly into one int32 key: the lexicographic order of the pair is the
integer order of the key.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device

CLIENT_BITS = 10
MAX_CLIENTS = 1 << CLIENT_BITS          # 1024
MAX_CLOCK = (1 << 20) - 1               # packed key stays < 2^30 (int32-safe)


def i32(x, device=None) -> torch.Tensor:
    """``x`` (a Python int, numpy value or tensor) as an int32 tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=torch.int32, device=device or x.device)
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def pack_key(clock, client) -> torch.Tensor:
    """Pack (clock, client) into one int32, preserving lexicographic order."""
    clock, client = i32(clock), i32(client)
    return clock * MAX_CLIENTS + client


def unpack_key(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.div(key, MAX_CLIENTS, rounding_mode="floor"),
            torch.remainder(key, MAX_CLIENTS))


class Lamport(NamedTuple):
    """Per-client Lamport clock (int32 scalars)."""

    time: torch.Tensor
    client: torch.Tensor

    @classmethod
    def create(cls, client: int, device=None) -> "Lamport":
        dev = resolve_device(device)
        return cls(time=i32(0, dev), client=i32(client, dev))

    def tick(self) -> "Lamport":
        return self._replace(time=self.time + 1)

    def observe(self, other_time) -> "Lamport":
        """Lamport receive rule: local = max(local, observed) + 1."""
        other = i32(other_time, self.time.device)
        return self._replace(time=torch.maximum(self.time, other) + 1)

    @property
    def key(self) -> torch.Tensor:
        return pack_key(self.time, self.client)


class VersionVector(NamedTuple):
    """How many ops of each client this replica has observed."""

    counts: torch.Tensor    # i32[C]

    @classmethod
    def zeros(cls, num_clients: int, device=None) -> "VersionVector":
        return cls(torch.zeros((num_clients,), dtype=torch.int32,
                               device=resolve_device(device)))

    def join(self, other: "VersionVector") -> "VersionVector":
        return VersionVector(torch.maximum(self.counts, other.counts))

    def dominates(self, other: "VersionVector") -> torch.Tensor:
        return torch.all(self.counts >= other.counts)

    def advance(self, client, count) -> "VersionVector":
        c = int(client)
        counts = self.counts.clone()
        counts[c] = torch.maximum(counts[c], i32(count, counts.device))
        return VersionVector(counts)
