"""Grow/shrink counters with per-replica lanes (PN-counters).

A ``PNCounter`` holds ``K`` keyed counters replicated across ``R`` writer
lanes.  Lane ``r`` is single-writer, so every cell is monotone and the join
is an elementwise max, while the observed value

    value[k] = sum_r (inc[r, k] - dec[r, k])

can go up and down.  ``dec <= inc`` cellwise is the auditable
no-double-free invariant of the replicated page refcounts.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.core.clock import i32


class PNCounter(NamedTuple):
    inc: torch.Tensor    # i32[R, K] — per-lane cumulative increments
    dec: torch.Tensor    # i32[R, K] — per-lane cumulative decrements

    @classmethod
    def zeros(cls, num_lanes: int, num_keys: int, device=None) -> "PNCounter":
        dev = resolve_device(device)
        return cls(inc=torch.zeros((num_lanes, num_keys), dtype=torch.int32,
                                   device=dev),
                   dec=torch.zeros((num_lanes, num_keys), dtype=torch.int32,
                                   device=dev))

    @property
    def num_lanes(self) -> int:
        return self.inc.shape[0]

    @property
    def num_keys(self) -> int:
        return self.inc.shape[1]

    def add(self, lane, key, amount=1) -> "PNCounter":
        """Increment ``key`` on ``lane`` (call only from lane's owner)."""
        inc = self.inc.clone()
        inc[int(lane), int(key)] += i32(amount, inc.device)
        return self._replace(inc=inc)

    def sub(self, lane, key, amount=1) -> "PNCounter":
        """Decrement ``key`` on ``lane``; the caller must hold the
        references it releases."""
        dec = self.dec.clone()
        dec[int(lane), int(key)] += i32(amount, dec.device)
        return self._replace(dec=dec)

    def join(self, other: "PNCounter") -> "PNCounter":
        return PNCounter(inc=torch.maximum(self.inc, other.inc),
                         dec=torch.maximum(self.dec, other.dec))

    @property
    def value(self) -> torch.Tensor:
        """Observed per-key value: i32[K]."""
        return (self.inc - self.dec).sum(dim=0, dtype=torch.int32)

    def value_masked(self, lanes: torch.Tensor) -> torch.Tensor:
        """Per-key value counting only ``lanes`` (bool[R])."""
        held = torch.where(lanes[:, None], self.inc - self.dec, 0)
        return held.sum(dim=0, dtype=torch.int32)

    def lane_value(self, lane) -> torch.Tensor:
        """One lane's per-key holdings: i32[K]."""
        return self.inc[lane] - self.dec[lane]
