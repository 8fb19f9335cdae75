"""Observation-driven adaptation.

An agent's subscription to CRDT events is a version-vector diff: between
decode steps the agent compares the merged state's per-slot versions with
its own snapshot.  ``invalidations`` is the context-invalidation signal: a
dependency's content changed after the agent snapshotted it, so the agent
must re-contextualize (re-prefill).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.doc import SlotDoc
from repro_torch.core.rga import RGA


class Snapshot(NamedTuple):
    """What an agent last observed, per document slot."""

    versions: torch.Tensor    # i32[K]


def snapshot(doc: SlotDoc) -> Snapshot:
    return Snapshot(versions=doc.version)


def changed_mask(snap: Snapshot, doc: SlotDoc) -> torch.Tensor:
    """bool[K] — slots whose content advanced since the snapshot."""
    return doc.version > snap.versions


def invalidations(snap: Snapshot, doc: SlotDoc,
                  deps_row: torch.Tensor) -> torch.Tensor:
    """True if any dependency slot changed since the snapshot (re-prefill)."""
    return torch.any(changed_mask(snap, doc) & deps_row)


def observation_count(snap: Snapshot, doc: SlotDoc) -> torch.Tensor:
    """Number of update events this observation delivers."""
    return (doc.version - snap.versions).clamp(min=0).sum(dtype=torch.int32)


class RGAFrontier(NamedTuple):
    """Version vector over an RGA replica (per-client op counts)."""

    counts: torch.Tensor    # i32[C]


def rga_frontier(state: RGA) -> RGAFrontier:
    return RGAFrontier(counts=state.count)


def rga_delta_mask(state: RGA, frontier: RGAFrontier) -> torch.Tensor:
    """bool[C, L] — ops not yet observed at ``frontier``."""
    idx = torch.arange(state.capacity, dtype=torch.int32,
                       device=state.count.device)[None, :]
    return (idx >= frontier.counts[:, None]) & state.valid_mask()
