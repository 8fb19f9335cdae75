"""Replicated CRDT page table — the distributed serving tier.

The scheduler's host-local ``PageAllocator`` refcounts and ``PrefixCache``
chain become replicated state shared by N serving engines:

  * per-page refcounts   — a PN-counter with one writer lane per replica
                           (``core/counter.py``): replica r's references to
                           page p live in lane r; the observed refcount is
                           the live-lane sum, so a crashed replica's zombie
                           references stop pinning pages once its retirement
                           is observed.
  * prefix → page map    — an LWW register bank (``core/lww.py``) keyed by a
                           62-bit hash of the token prefix: full chain pages
                           (immutable once filled) are published so peers
                           can discover shareable prompt KV.
  * page ownership       — an LWW lease ``(owner, seq)`` per page.  ``seq``
                           is the page's *epoch*: it bumps on every alloc
                           AND every free-to-zero, so any stale reference a
                           peer resolved under an old epoch fails validation
                           instead of aliasing reused KV.
  * liveness             — heartbeat G-counter + retirement-vote G-set.
  * request journal      — a G-log lane per replica (crash failover).

All of it syncs through the delta engine (``core/delta.py``: ``frontier``
/ ``extract`` / ``apply`` on the registered CRDT leaves), shipped as
fixed-capacity packets by ``AntiEntropyNode`` (host gossip with per-peer
ack frontiers).

Where the state lives: the control plane is host-resident, as in the JAX
package.  Each replica's working state is numpy arrays (mutations are
scalar ops on the admission / growth path); gossip runs the port's delta
engine on CPU tensors viewed from those arrays.  This is the control
plane's placement, not a fallback: the engines, their page pools and the
physical page transfers stay on the card.

Protocol rules (verified by serving/simulator.py)
-------------------------------------------------

1. **Home-partition allocation.**  Page p is allocated only by its home
   replica ``home(p) = p * N // P``, so allocation never needs consensus.
   Any replica may *reference* any page (prefix sharing); only the lease
   owner writes it.

2. **Epoch fencing.**  The lease seq bumps on alloc and on free-to-zero.
   Published prefix entries carry the seq they were minted under; every
   cross-replica resolution re-validates ``seq`` against the current lease.

3. **Provisional cross-replica shares.**  A replica adopting a peer's page
   increments its own refcount lane first, then commits only after it has
   since *heard from the owner* with the epoch unchanged; otherwise it
   aborts and decrements.  The home absorbs the in-flight window by
   lingering: an exported page that reaches refcount 0 cools for
   ``linger`` steps (and is re-validated at promotion) before re-entering
   the free list.

4. **Fencing / retirement / reclamation.**  Replicas heartbeat every step.
   A replica FENCES ITSELF (stops allocating and writing) while any
   non-retired peer has been unheard for > ``ttl`` steps — during a
   partition *both* sides stall rather than risk divergent ownership.  A
   peer whose merged heartbeat is stale by > ``2*ttl`` gets a retirement
   vote; retirement takes effect at a majority (floor(N/2)+1), so an N=2
   crash pins pages forever rather than reclaiming unsafely.  The lowest-id
   live replica then re-homes a retired replica's pages: claim (lease
   write, seq+1) → wait ``grace`` → commit if still the lease winner and
   itself unfenced.  An isolated owner fences at ``ttl`` unheard, strictly
   before any claim can commit at ``2*ttl (vote) + grace``.

5. **Self-halt.**  A replica that observes its own retirement stops
   operating (its lanes are already excluded from effective refcounts).

The engine-facing adapters ``ReplicatedPageAllocator`` /
``ReplicatedPrefixCache`` are drop-in for the scheduler's ``PageAllocator``
/ ``PrefixCache`` API, so ``ContinuousBatchingEngine(allocator=...,
prefix_cache=...)`` runs unmodified on replicated state.
``MultiEngineServer`` drives N such engines with in-process gossip; with
prefill / decode roles its decode replicas adopt published physical pages
at admission (``cache.copy_pages_across``, the ``page_transfer`` kernel on
the card) instead of recomputing the prefix.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

import torch

from repro_torch.core import counter as counter_mod
from repro_torch.core import delta as delta_mod
from repro_torch.core import gset, lww
from repro_torch.core.clock import MAX_CLIENTS, MAX_CLOCK
from repro_torch.models import cache as cache_mod
from repro_torch.serving import engine as engine_mod
from repro_torch.serving import scheduler as sched_mod

HASH_BITS = 62

# Request-journal entry tags (the ``tag`` field of the ``journal`` GLog).
# The journal is the crash-failover substrate: every accepted request's
# descriptor (prompt tokens + generated-so-far) is journaled in its owner
# replica's append-only lane and gossips with the rest of the CRDT state,
# so any survivor can reconstruct a crashed replica's in-flight requests.
#   ACCEPT : a = (prompt_len << 16) | max_new_tokens, b = eos_id+1 (0=None)
#   PROMPT : a = position, b = token            (one entry per prompt token)
#   GEN    : a = output index, b = token        (one entry per decode step)
#   DONE / SHED / EXPIRED / FAIL : terminal markers (DONE: a = output len)
#   ADOPT  : a = retry count — a survivor took ownership after retirement
#   XFER_BEGIN / XFER_COMMIT / XFER_ABORT : physical page adoption
#     (disaggregation): a = page, b = publishing lease seq, rid = the
#     adopting request.  Every BEGIN is closed by exactly one COMMIT or
#     ABORT in the same lane — the chaos harness asserts the balance, and
#     an ABORT means the adopter rolled back (the page was never bound to
#     a row, so discarding the staged bytes is the whole rollback).
(J_ACCEPT, J_PROMPT, J_GEN, J_DONE,
 J_SHED, J_EXPIRED, J_ADOPT, J_FAIL,
 J_XFER_BEGIN, J_XFER_COMMIT, J_XFER_ABORT) = range(11)

JOURNAL_FIELDS = {"rid": ((), torch.int32), "tag": ((), torch.int32),
                  "a": ((), torch.int32), "b": ((), torch.int32)}
HOST = "cpu"              # where the CRDT control plane lives


def prefix_hash(key: tuple) -> int:
    """Deterministic 62-bit FNV-1a of an int tuple (a token prefix).  Both
    31-bit halves fit an int32 lane of the LWW payload."""
    h = 0xcbf29ce484222325
    for t in key:
        h ^= int(t) & 0xFFFFFFFFFFFFFFFF
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h & ((1 << HASH_BITS) - 1)


def zero_state(num_replicas: int, num_pages: int, prefix_slots: int,
               journal_capacity: int = 256) -> dict:
    """The pristine CRDT tree every replica starts from (and the template
    gossip frontiers are seeded with), on the host."""
    i32 = ((), torch.int32)
    return {
        "ref": counter_mod.PNCounter.zeros(num_replicas, num_pages,
                                           device=HOST),
        "lease": lww.empty(num_pages, {"owner": i32, "seq": i32},
                           device=HOST),
        "prefix": lww.empty(prefix_slots, {"hash_lo": i32, "hash_hi": i32,
                                           "page": i32, "seq": i32,
                                           "owner": i32}, device=HOST),
        "hb": gset.GCounter.zeros(num_replicas, device=HOST),
        "retire": gset.GSet.empty(num_replicas * num_replicas, device=HOST),
        "journal": gset.GLog.empty(num_replicas, journal_capacity,
                                   JOURNAL_FIELDS, device=HOST),
    }


class ReplicatedPageStore:
    """One replica's view of the replicated page table.

    Working state is host numpy (mutations are O(1) scalar ops on the hot
    admission/growth path); ``state()`` materializes the registered CRDT
    tree for the delta engine and ``load()`` writes a joined state back.
    Local mutators implement exactly the CRDT op semantics — single-writer
    monotone lane bumps, Lamport-guarded LWW writes — so a replica's state
    is always the join of the ops it generated and the deltas it applied.
    """

    def __init__(self, rid: int, num_replicas: int, num_pages: int,
                 prefix_slots: Optional[int] = None,
                 journal_capacity: int = 256):
        if not 0 <= rid < num_replicas:
            raise ValueError(f"rid {rid} outside [0, {num_replicas})")
        if num_replicas >= MAX_CLIENTS:
            raise ValueError("num_replicas exceeds LWW client space")
        self.rid = rid
        self.num_replicas = num_replicas
        self.num_pages = num_pages
        self.prefix_slots = (2 * num_pages if prefix_slots is None
                             else prefix_slots)
        self.journal_capacity = journal_capacity
        self.majority = num_replicas // 2 + 1
        n, p, s = num_replicas, num_pages, self.prefix_slots
        self.inc = np.zeros((n, p), np.int32)
        self.dec = np.zeros((n, p), np.int32)
        self.lease_clock = np.zeros(p, np.int32)
        self.lease_client = np.zeros(p, np.int32)
        self.lease_owner = np.zeros(p, np.int32)      # rid+1; 0 = unleased
        self.lease_seq = np.zeros(p, np.int32)
        self.pfx_clock = np.zeros(s, np.int32)
        self.pfx_client = np.zeros(s, np.int32)
        self.pfx = {name: np.zeros(s, np.int32)
                    for name in ("hash_lo", "hash_hi", "page", "seq",
                                 "owner")}
        self.hb = np.zeros(n, np.int32)
        self.retire = np.zeros(n * n, bool)
        self.jr_count = np.zeros(n, np.int32)
        self.jr = {name: np.zeros((n, journal_capacity), np.int32)
                   for name in ("rid", "tag", "a", "b")}
        self.journal_dropped = 0          # appends lost to a full lane
        self.lam = 0                                  # local Lamport time
        # Host metadata (not CRDT state): gossip recency per peer, fed by
        # AntiEntropyNode and read by the fencing rule.
        self.last_heard = {j: 0 for j in range(n) if j != rid}

    # -- Lamport ------------------------------------------------------------

    def _tick(self) -> int:
        self.lam += 1
        if self.lam > MAX_CLOCK:
            raise OverflowError("Lamport clock exhausted")
        return self.lam

    # -- refcount lanes (single-writer: own lane only) ----------------------

    def ref_add(self, page: int, n: int = 1) -> None:
        self.inc[self.rid, page] += n

    def ref_sub(self, page: int, n: int = 1) -> None:
        if self.lane_held(page) < n:
            raise ValueError(
                f"double free of page {page} (lane {self.rid} holds "
                f"{self.lane_held(page)}, releasing {n})")
        self.dec[self.rid, page] += n

    def lane_held(self, page: int) -> int:
        return int(self.inc[self.rid, page] - self.dec[self.rid, page])

    def retired_mask(self) -> np.ndarray:
        """bool[N] — replicas whose retirement has majority support in this
        replica's merged view.  Votes are monotone facts, so every replica
        converges to the same mask."""
        n = self.num_replicas
        votes = self.retire.reshape(n, n).sum(axis=0)
        return votes >= self.majority

    def live_lanes(self) -> np.ndarray:
        return ~self.retired_mask()

    def refcount(self, page: int) -> int:
        live = self.live_lanes()
        return int((self.inc[live, page] - self.dec[live, page]).sum())

    def refcounts(self) -> np.ndarray:
        """Effective (live-lane) refcount of every page: i32[P]."""
        live = self.live_lanes()
        return (self.inc[live] - self.dec[live]).sum(axis=0)

    # -- lease --------------------------------------------------------------

    def _lww_write(self, clock_arr, client_arr, idx: int,
                   fields: dict[str, dict]) -> bool:
        clock = self._tick()
        client = self.rid + 1
        new_key = clock * MAX_CLIENTS + client
        cur_key = int(clock_arr[idx]) * MAX_CLIENTS + int(client_arr[idx])
        if new_key <= cur_key:
            return False
        clock_arr[idx] = clock
        client_arr[idx] = client
        for payload, values in fields.items():
            for name, value in values.items():
                getattr(self, payload)[name][idx] = value
        return True

    def lease_write(self, page: int, owner_rid: int, seq: int) -> None:
        ok = self._lww_write(
            self.lease_clock, self.lease_client, page,
            {"_lease_payload": {"owner": owner_rid + 1, "seq": seq}})
        if not ok:
            raise RuntimeError(f"lease write lost on page {page} — a local "
                               "Lamport tick can never lose locally")

    @property
    def _lease_payload(self) -> dict[str, np.ndarray]:
        return {"owner": self.lease_owner, "seq": self.lease_seq}

    def lease(self, page: int) -> tuple[int, int]:
        """(owner_rid or -1, seq) of the page's current epoch."""
        return int(self.lease_owner[page]) - 1, int(self.lease_seq[page])

    # -- prefix map ---------------------------------------------------------

    def publish_prefix(self, h: int, page: int, seq: int) -> None:
        slot = h % self.prefix_slots
        self._lww_write(
            self.pfx_clock, self.pfx_client, slot,
            {"pfx": {"hash_lo": h & 0x7FFFFFFF, "hash_hi": h >> 31,
                     "page": page, "seq": seq, "owner": self.rid + 1}})

    def lookup_prefix(self, h: int) -> Optional[tuple[int, int, int]]:
        """(owner_rid, page, seq) of a published prefix page, or None.  The
        caller still must validate seq against the page's current lease."""
        slot = h % self.prefix_slots
        if self.pfx_clock[slot] == 0:
            return None
        if (int(self.pfx["hash_lo"][slot]) != (h & 0x7FFFFFFF)
                or int(self.pfx["hash_hi"][slot]) != (h >> 31)):
            return None                     # slot collision — treat as miss
        return (int(self.pfx["owner"][slot]) - 1,
                int(self.pfx["page"][slot]), int(self.pfx["seq"][slot]))

    # -- request journal (single-writer: own lane only) ---------------------

    def journal_append(self, rid: int, tag: int, a: int = 0, b: int = 0
                       ) -> None:
        """One entry in this replica's journal lane (GLog semantics: drops
        silently when the lane is full — ``journal_dropped`` counts it, and
        a request whose descriptor is incomplete fails over as FAIL instead
        of resurrecting with corrupt state)."""
        i = int(self.jr_count[self.rid])
        if i >= self.journal_capacity:
            self.journal_dropped += 1
            return
        for name, v in (("rid", rid), ("tag", tag), ("a", a), ("b", b)):
            self.jr[name][self.rid, i] = v
        self.jr_count[self.rid] = i + 1

    def journal_entries(self):
        """Every journal entry visible in this replica's merged view, as
        ``(lane, rid, tag, a, b)`` — per-lane append order within a lane."""
        for lane in range(self.num_replicas):
            for i in range(int(self.jr_count[lane])):
                yield (lane, int(self.jr["rid"][lane, i]),
                       int(self.jr["tag"][lane, i]),
                       int(self.jr["a"][lane, i]),
                       int(self.jr["b"][lane, i]))

    # -- liveness -----------------------------------------------------------

    def heartbeat(self, now: int) -> None:
        self.hb[self.rid] = max(int(self.hb[self.rid]), now)

    def vote_retire(self, target: int) -> None:
        self.retire[self.rid * self.num_replicas + target] = True

    def is_retired(self, r: int) -> bool:
        return bool(self.retired_mask()[r])

    # -- CRDT tree bridge ---------------------------------------------------

    def state(self) -> dict:
        """The registered-CRDT tree this replica's state IS (the thing the
        delta engine extracts from / applies into / joins): CPU tensors
        that view the working arrays (the delta engine never writes its
        inputs; ``load`` takes copies)."""
        t = torch.from_numpy
        return {
            "ref": counter_mod.PNCounter(inc=t(self.inc), dec=t(self.dec)),
            "lease": lww.LWWBank(
                clock=t(self.lease_clock), client=t(self.lease_client),
                payload={"owner": t(self.lease_owner),
                         "seq": t(self.lease_seq)}),
            "prefix": lww.LWWBank(
                clock=t(self.pfx_clock), client=t(self.pfx_client),
                payload={k: t(v) for k, v in self.pfx.items()}),
            "hb": gset.GCounter(t(self.hb)),
            "retire": gset.GSet(t(self.retire)),
            "journal": gset.GLog(
                count=t(self.jr_count),
                fields={k: t(v) for k, v in self.jr.items()}),
        }

    def load(self, tree: dict) -> None:
        """Adopt a joined state (post delta-apply) and observe its clocks so
        later local LWW writes stay ahead of everything merged in."""
        host = lambda x: np.array(x.numpy())   # mutable host copy
        self.inc = host(tree["ref"].inc)
        self.dec = host(tree["ref"].dec)
        self.lease_clock = host(tree["lease"].clock)
        self.lease_client = host(tree["lease"].client)
        self.lease_owner = host(tree["lease"].payload["owner"])
        self.lease_seq = host(tree["lease"].payload["seq"])
        self.pfx_clock = host(tree["prefix"].clock)
        self.pfx_client = host(tree["prefix"].client)
        self.pfx = {k: host(v) for k, v in tree["prefix"].payload.items()}
        self.hb = host(tree["hb"].counts)
        self.retire = host(tree["retire"].member)
        self.jr_count = host(tree["journal"].count)
        self.jr = {k: host(v) for k, v in tree["journal"].fields.items()}
        self.lam = max(self.lam, int(self.lease_clock.max()),
                       int(self.pfx_clock.max()))

    def apply_delta(self, d: Any) -> None:
        self.load(delta_mod.apply(self.state(), d))

    def digest(self) -> bytes:
        """Order-stable byte digest of the CRDT state (for convergence
        traces; bitwise equality of digests == bitwise equality of state)."""
        import hashlib
        m = hashlib.sha256()
        for arr in (self.inc, self.dec, self.lease_clock, self.lease_client,
                    self.lease_owner, self.lease_seq, self.pfx_clock,
                    self.pfx_client, *(self.pfx[k] for k in sorted(self.pfx)),
                    self.hb, self.retire, self.jr_count,
                    *(self.jr[k] for k in sorted(self.jr))):
            m.update(np.ascontiguousarray(arr).tobytes())
        return m.digest()


# ---------------------------------------------------------------------------
# Anti-entropy gossip (delta engine on an unreliable channel)
# ---------------------------------------------------------------------------


@dataclass
class DeltaPacket:
    """One gossip hop: a fixed-capacity delta of src's state beyond what dst
    last acknowledged.  ``nbytes`` is constant per (store shape, capacity) —
    that is what makes sync-bytes a deterministic, regression-gatable
    counter."""

    src: int
    dst: int
    send_time: int
    delta: Any
    nbytes: int


@dataclass
class AckPacket:
    src: int
    dst: int
    send_time: int


class AntiEntropyNode:
    """Per-replica gossip endpoint with per-peer acknowledged frontiers.

    Unlike ``delta.DeltaSync`` (reliable shared-frontier all-to-all), this
    node tolerates an adversarial channel: the frontier for a peer advances
    only when that peer ACKNOWLEDGES a packet, so dropped packets simply
    re-extract on the next round; duplicated or reordered packets are
    no-ops by join idempotence/commutativity; delayed acks join in late
    (frontiers are monotone).  Convergence is delayed, never lost.
    """

    PENDING_LIMIT = 64        # unacked shipped-frontiers kept per peer

    def __init__(self, store: ReplicatedPageStore, capacity: int = 32,
                 gossip=None, journal_capacity: Optional[int] = None):
        self.store = store
        self.capacity = capacity
        # The journal lane is chattier than the page-table leaves (one entry
        # per prompt/decode token), so it ships with its own, larger delta
        # capacity — a per-leaf override resolved by delta._cap_for.
        jcap = min(store.journal_capacity,
                   4 * capacity if journal_capacity is None
                   else journal_capacity)
        cap_spec = (("journal", jcap), ("*", capacity))
        self.gossip = gossip if gossip is not None else \
            engine_mod.make_gossip_fns(
                zero_state(store.num_replicas, store.num_pages,
                           store.prefix_slots, store.journal_capacity),
                cap_spec)
        peers = [j for j in range(store.num_replicas) if j != store.rid]
        self.acked = {j: self.gossip.genesis for j in peers}
        self.pending: dict[int, dict[int, Any]] = {j: {} for j in peers}
        self.bytes_sent = 0
        self.packets_sent = 0

    def make_packet(self, dst: int, now: int) -> DeltaPacket:
        d, shipped = self.gossip.extract(self.store.state(), self.acked[dst])
        pend = self.pending[dst]
        pend[now] = shipped
        while len(pend) > self.PENDING_LIMIT:
            pend.pop(min(pend))           # oldest unacked: superseded anyway
        nb = delta_mod.nbytes(d)
        self.bytes_sent += nb
        self.packets_sent += 1
        return DeltaPacket(self.store.rid, dst, now, d, nb)

    def receive(self, pkt: DeltaPacket, now: int) -> AckPacket:
        self.store.last_heard[pkt.src] = max(self.store.last_heard[pkt.src],
                                             now)
        self.store.load(self.gossip.apply(self.store.state(), pkt.delta))
        return AckPacket(self.store.rid, pkt.src, pkt.send_time)

    def receive_ack(self, ack: AckPacket, now: int) -> None:
        self.store.last_heard[ack.src] = max(self.store.last_heard[ack.src],
                                             now)
        fr = self.pending[ack.src].pop(ack.send_time, None)
        if fr is not None:
            self.acked[ack.src] = delta_mod.join_frontiers(
                self.acked[ack.src], fr)


# ---------------------------------------------------------------------------
# Scheduler-facing backends
# ---------------------------------------------------------------------------


class ReplicatedPageAllocator:
    """Drop-in for ``scheduler.PageAllocator`` backed by the replicated
    store.  Allocation draws from this replica's home partition only;
    refcounts, leases and the retirement protocol ride the CRDT state.

    ``ttl``/``grace``/``linger`` are in the caller's step units (the
    simulator's logical clock, or engine steps for ``MultiEngineServer``).
    The safety inequality — fence at ``ttl`` < retire-vote at ``2*ttl`` +
    ``grace`` — is baked in; ``linger`` must exceed the channel's maximum
    in-flight time for rule 3 (see module docstring) to hold.
    """

    def __init__(self, store: ReplicatedPageStore, *, ttl: int = 8,
                 grace: Optional[int] = None, linger: int = 0):
        self.store = store
        self.ttl = ttl
        self.retire_after = 2 * ttl
        self.grace = ttl if grace is None else grace
        self.linger = linger
        p, n, rid = store.num_pages, store.num_replicas, store.rid
        self._home0 = (np.arange(p, dtype=np.int64) * n) // p
        self._mine = {int(pg) for pg in np.nonzero(self._home0 == rid)[0]}
        self._free = sorted(self._mine, reverse=True)
        self._outstanding: set[int] = set()
        self._cooling: dict[int, int] = {}      # page -> cooled-since step
        self._exported: set[int] = set()
        self._claims: dict[int, tuple[int, int]] = {}   # page -> (t0, seq)
        self.now = 0                            # advanced by maintain()
        self.reclaimed_pages = 0
        self.fence_steps = 0

    # -- PageAllocator API --------------------------------------------------

    @property
    def num_pages(self) -> int:
        return self.store.num_pages        # engines size their pool to this

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[list[int]]:
        if n <= 0:
            return []
        if self.halted or self.fenced(self.now) or n > len(self._free):
            return None
        pages, self._free = self._free[-n:][::-1], self._free[:-n]
        for p in pages:
            _, seq = self.store.lease(p)
            self.store.lease_write(p, self.store.rid, seq + 1)
            self.store.ref_add(p)
            self._outstanding.add(p)
        return pages

    def reserve(self, n: int) -> Optional[sched_mod.Reservation]:
        pages = self.alloc(n)
        if pages is None:
            return None
        return sched_mod.Reservation(self, pages)

    def share(self, pages: list[int], row: Optional[int] = None) -> None:
        for p in pages:
            if self.store.refcount(p) <= 0:
                raise ValueError(
                    f"cannot share unallocated page {p}"
                    f"{sched_mod._row_ctx(row)} (refcount "
                    f"{self.store.refcount(p)})")
            self.store.ref_add(p)

    def refcount(self, page: int) -> int:
        return self.store.refcount(page)

    def generation(self, page: int) -> int:
        """The page's lease epoch: bumps on every alloc and every
        free-to-zero, which is exactly the staleness the local PrefixCache
        guards against."""
        return self.store.lease(page)[1]

    def free(self, pages: list[int], row: Optional[int] = None) -> None:
        for p in reversed(pages):
            if self.store.lane_held(p) < 1:
                raise ValueError(
                    f"double free of page {p}{sched_mod._row_ctx(row)} "
                    f"(lane {self.store.rid} holds "
                    f"{self.store.lane_held(p)})")
            self.store.ref_sub(p)          # raises on lane double-free
            self._retire_if_idle(p)

    # -- replication-side machinery ------------------------------------------

    def _retire_if_idle(self, p: int) -> None:
        """Home-side: a page of ours at effective refcount 0 ends its epoch
        (seq bump fences stale references) and cools or frees."""
        if p not in self._mine or p not in self._outstanding:
            return
        if self.store.refcount(p) != 0:
            return                         # remote lanes still hold refs
        _, seq = self.store.lease(p)
        self.store.lease_write(p, self.store.rid, seq + 1)
        self._outstanding.discard(p)
        if p in self._exported and self.linger > 0:
            self._cooling[p] = self.now
        else:
            self._free.append(p)

    def mark_exported(self, page: int) -> None:
        self._exported.add(page)

    def scavenge(self) -> None:
        """After a sync round: reap home pages whose last remote references
        were released elsewhere, and promote cooled pages whose linger has
        elapsed (re-validating refcount — an in-flight provisional share
        may have resurrected one; it will abort on the epoch bump, so the
        page just keeps cooling until the release arrives)."""
        for p in sorted(self._outstanding):
            self._retire_if_idle(p)
        for p in sorted(self._cooling):
            if self.now - self._cooling[p] >= self.linger:
                if self.store.refcount(p) == 0:
                    del self._cooling[p]
                    self._free.append(p)
                else:
                    self._cooling[p] = self.now

    @property
    def halted(self) -> bool:
        return self.store.is_retired(self.store.rid)

    def fenced(self, now: int) -> bool:
        """Safety rule 4: stall while any non-retired peer is unheard."""
        retired = self.store.retired_mask()
        return any(now - t > self.ttl
                   for j, t in self.store.last_heard.items()
                   if not retired[j])

    def maintain(self, now: int) -> None:
        """One protocol step: heartbeat, stale-peer votes, reclamation."""
        self.now = now
        if self.halted:
            return
        self.store.heartbeat(now)
        retired = self.store.retired_mask()
        for j in self.store.last_heard:
            if not retired[j] and now - int(self.store.hb[j]) \
                    > self.retire_after:
                self.store.vote_retire(j)
        retired = self.store.retired_mask()
        if self.fenced(now):
            self.fence_steps += 1
            self._claims.clear()           # a fenced claimant starts over
            return
        live = [r for r in range(self.store.num_replicas) if not retired[r]]
        if not live or live[0] != self.store.rid:
            return
        # Lowest live replica re-homes every retired replica's pages.
        for p in np.nonzero(retired[self._home0])[0]:
            p = int(p)
            if p in self._mine:
                continue
            owner, seq = self.store.lease(p)
            claim = self._claims.get(p)
            if claim is None:
                self.store.lease_write(p, self.store.rid, seq + 1)
                self._claims[p] = (now, seq + 1)
            else:
                t0, cseq = claim
                if owner != self.store.rid or seq != cseq:
                    del self._claims[p]    # lost the epoch — retry next step
                elif now - t0 >= self.grace:
                    del self._claims[p]
                    self._mine.add(p)
                    self.reclaimed_pages += 1
                    if self.store.refcount(p) == 0:
                        self._free.append(p)
                    else:                  # live sharers elsewhere
                        self._outstanding.add(p)


class ReplicatedPrefixCache(sched_mod.PrefixCache):
    """The scheduler's ``PrefixCache`` plus cross-replica publication.

    Local lookups/registration behave exactly like the host-local cache
    (same OrderedDict LRU, same generation validation — the generation now
    being the page's replicated lease epoch).  On top of that, full chain
    pages this replica OWNS are published to the replicated prefix map, and
    ``resolve_remote`` probes the map for prompt pages resident on peers.
    ``cross_replica_hits`` counts *committed* uses of a remote page — the
    share/adoption survived the rule-3 epoch re-check — not raw resolves,
    so the bench counter only ever counts usable hits.

    Physical adoption needs one more fact registration cannot carry: the
    local cache registers at reservation time, before the owner's chunk
    writes land the bytes.  ``mark_filled`` records (page → lease seq) once
    this engine has physically written a page, and cross-replica
    publication is DEFERRED until then — the replicated map only ever
    advertises pages whose bytes landed, so it implicitly carries the
    data-plane readiness flag an RDMA transport would signal out of band.
    (Adopters still re-check the exporter's ``filled_seq`` before
    transferring: a later re-registration of the same prefix may have
    re-homed the map entry onto a page mid-write.)
    """

    def __init__(self, allocator: ReplicatedPageAllocator, page_size: int,
                 max_entries: int = 4096):
        super().__init__(allocator, page_size, max_entries)
        self.store = allocator.store
        self.cross_replica_hits = 0
        self.published = 0
        self.filled: dict[int, int] = {}   # page -> lease seq at fill time
        self._pending: dict[int, tuple[int, int]] = {}  # page -> (hash, seq)

    def mark_filled(self, pages: list[int]) -> None:
        """Record that this engine's pool physically holds ``pages``' bytes
        (called by the scheduler once the covering writes have landed, and
        by the server after a committed transfer), and flush any deferred
        publication for them."""
        for pg in pages:
            pg = int(pg)
            _owner, seq = self.store.lease(pg)
            self.filled[pg] = seq
            pend = self._pending.pop(pg, None)
            if pend is not None and pend[1] == seq:
                self._do_publish(pend[0], pg, seq)

    def filled_seq(self, page: int) -> Optional[int]:
        """The lease seq this engine's bytes for ``page`` were written
        under, or None if unwritten / stale (the epoch moved since: the
        page was freed-to-zero or re-homed, so the bytes are garbage)."""
        seq = self.filled.get(int(page))
        if seq is None:
            return None
        _owner, cur = self.store.lease(int(page))
        return seq if cur == seq else None

    def _do_publish(self, h: int, page: int, seq: int) -> None:
        self.store.publish_prefix(h, page, seq)
        self._allocator.mark_exported(page)
        self.published += 1

    def _publish_page(self, key: tuple, page: int) -> None:
        owner, seq = self.store.lease(page)
        if owner != self.store.rid:
            return                         # only the lease owner publishes
        h = prefix_hash(key)
        if self.filled_seq(page) == seq:
            self._do_publish(h, page, seq)
        else:                              # bytes not landed yet: defer to
            self._pending[page] = (h, seq)  # mark_filled (publish-on-fill)

    def _publish_chain(self, tokens: list[int], pages: list[int]) -> None:
        ps = self.page_size
        for k in range(1, min(len(tokens) // ps, len(pages)) + 1):
            self._publish_page(tuple(tokens[:k * ps]), pages[k - 1])

    def register(self, tokens: list[int], pages: list[int]) -> None:
        super().register(tokens, pages)
        self._publish_chain(tokens, pages)

    def register_tail(self, tokens: list[int], pages: list[int]) -> None:
        super().register_tail(tokens, pages)
        ps = self.page_size
        k = len(pages)
        if k and k * ps <= len(tokens):    # the page just grown is full
            self._publish_page(tuple(tokens[:k * ps]), pages[k - 1])

    def resolve_remote(self, key: tuple) -> Optional[tuple[int, int, int]]:
        """Validated replicated-map probe for the full chain page covering
        ``key``: (owner_rid, page, seq), or None.  Validation: hash match,
        publishing epoch still current, page still referenced, owner lane
        still live.  The *caller* performs the provisional share + commit
        dance (protocol rule 3)."""
        hit = self.store.lookup_prefix(prefix_hash(key))
        if hit is None:
            return None
        owner, page, seq = hit
        if owner < 0 or owner >= self.store.num_replicas:
            return None
        cur_owner, cur_seq = self.store.lease(page)
        if (cur_seq != seq or cur_owner != owner
                or self.store.retired_mask()[owner]
                or self.store.refcount(page) <= 0):
            return None
        return owner, page, seq

    # NOTE: ``lookup`` is the inherited local-only longest-prefix match.
    # Remote continuation is the server's adoption hook: it resolves,
    # transfers the physical bytes, and bumps ``cross_replica_hits`` only
    # on commit — a resolve the epoch re-check aborts is not a usable hit.


# ---------------------------------------------------------------------------
# Multi-engine serving
# ---------------------------------------------------------------------------


class ReliableChannel:
    """Lossless in-process transport: every packet sent this tick delivers
    this tick, in send order.  API-compatible with the simulator's
    ``FaultyChannel`` (``send``/``deliver``/``in_flight``/``healed``), so
    ``MultiEngineServer`` syncs through either interchangeably."""

    def __init__(self):
        self._q: list = []
        self.sent = 0
        self.healed = True                 # nothing to heal

    def send(self, pkt, now: int) -> None:
        self._q.append(pkt)
        self.sent += 1

    def deliver(self, now: int) -> list:
        out, self._q = self._q, []
        return out

    @property
    def in_flight(self) -> int:
        return len(self._q)


class MultiEngineServer:
    """N continuous-batching engines on one replicated page table.

    Each engine gets its own ``ReplicatedPageStore`` replica plus the
    allocator/prefix-cache adapters; requests are dispatched round-robin;
    every ``sync_every`` steps the replicas gossip all-to-all through their
    ``AntiEntropyNode``s over ``channel`` — the default ``ReliableChannel``
    (under which ``ttl`` is sized so the fencing rule never fires) or the
    simulator's ``FaultyChannel``, which subjects the *real* engines to
    drop/dup/delay/reorder/partition schedules.

    Fault tolerance (the simulator's fault model, on the real engines):

      * Every accepted request's descriptor is journaled in its owner's
        CRDT journal lane (``J_ACCEPT`` + per-token ``J_PROMPT``, then one
        ``J_GEN`` per decode step and a terminal marker) and gossips with
        the page table.
      * ``crash(r)`` crash-stops replica r mid-flight.  Its heartbeat
        freezes; survivors fence, vote, and retire it through the existing
        lease/TTL/majority machinery, after which its pages re-home and
        the lowest live replica ADOPTS its unfinished requests: each is
        reconstructed from the merged journal (prompt + generated-so-far)
        and re-admitted — through the prefix cache, so recovered prefill
        is mostly page hits — with capped retries and deterministic
        backoff (``engine.backoff_steps``).
      * Exactly-once delivery = journaled ``J_DONE``: completion is
        recorded once (re-runs that find a DONE already visible suppress
        the duplicate), and the adopter is deterministic (lowest live), so
        an accepted-and-not-shed request completes exactly once.
      * Crash failover needs enough survivors to form a retirement
        majority (``floor(N/2)+1``): with N=2 a crashed peer's requests
        stay pinned rather than being reclaimed unsafely — the same
        trade the page table itself makes.

    ``journal_delta_capacity`` (default ``4 * delta_capacity``, as in the
    JAX package) caps the journal entries a packet ships: long prompts
    journal one entry per token, and a descriptor a crashed replica never
    shipped is lost.
    """

    def __init__(self, cfg, params, *, replicas: int = 2, batch: int,
                 max_len: int, page_size: int = 64,
                 pages_per_replica: Optional[int] = None,
                 sync_every: int = 1, delta_capacity: int = 32,
                 channel=None, ttl: Optional[int] = None,
                 journal_capacity: int = 256,
                 max_queue: Optional[int] = None, max_retries: int = 2,
                 adopt_grace: Optional[int] = None,
                 roles: Optional[list] = None,
                 adopt_pages: bool = True,
                 journal_delta_capacity: Optional[int] = None,
                 **engine_kwargs):
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        if roles is None:
            roles = ["mixed"] * replicas
        roles = list(roles)
        if len(roles) != replicas:
            raise ValueError(f"roles must name every replica: got "
                             f"{len(roles)} roles for {replicas} replicas")
        for role in roles:
            if role not in ("prefill", "decode", "mixed"):
                raise ValueError(f"role must be prefill/decode/mixed, "
                                 f"got {role!r}")
        self.roles = roles
        self.replicas = replicas
        self.sync_every = sync_every
        self.impl = engine_kwargs.get("impl", "kernel")
        maxp = -(-max_len // page_size)
        per = pages_per_replica if pages_per_replica is not None \
            else batch * maxp
        num_pages = replicas * per
        ttl = 4 * sync_every if ttl is None else ttl
        self.channel = channel if channel is not None else ReliableChannel()
        self.max_retries = max_retries
        self.adopt_grace = ttl if adopt_grace is None else adopt_grace
        self.stores = [ReplicatedPageStore(r, replicas, num_pages,
                                           journal_capacity=journal_capacity)
                       for r in range(replicas)]
        gossip = None
        self.allocators, self.caches, self.nodes = [], [], []
        for store in self.stores:
            node = AntiEntropyNode(store, capacity=delta_capacity,
                                   gossip=gossip,
                                   journal_capacity=journal_delta_capacity)
            gossip = node.gossip           # share the genesis frontier
            alloc = ReplicatedPageAllocator(store, ttl=ttl, linger=0)
            self.nodes.append(node)
            self.allocators.append(alloc)
            self.caches.append(ReplicatedPrefixCache(alloc, page_size))
        self.engines = [
            sched_mod.ContinuousBatchingEngine(
                cfg, params, batch=batch, max_len=max_len, paged=True,
                page_size=page_size, num_pages=num_pages,
                prefix_sharing=True, allocator=self.allocators[r],
                prefix_cache=self.caches[r], max_queue=max_queue,
                journal=(lambda rr: lambda kind, req:
                         self._journal(rr, kind, req))(r),
                role=roles[r],
                **engine_kwargs)
            for r in range(replicas)]
        # Disaggregation data plane: decode/mixed replicas adopt published
        # physical pages from peers at admission (prefill replicas only
        # export).  The hook runs the rule-3 share + transfer + commit
        # dance; see ``_adopt``.  ``adopt_pages=False`` keeps the
        # coordination layer (publication, routing) but never moves bytes —
        # the local-prefill baseline the disagg bench compares against.
        if adopt_pages:
            for r, eng in enumerate(self.engines):
                if eng.role != "prefill":
                    eng.adopt_hook = (lambda rr: lambda rid, ctx, shared:
                                      self._adopt(rr, rid, ctx, shared))(r)
        self.transfer_bytes = 0            # physical bytes moved by adoption
        self.transferred_pages = 0         # committed page transfers
        self.adopt_aborts = 0              # rule-3 aborts (epoch moved/crash)
        self._xfer_crash: Optional[tuple[int, int]] = None
        self.clock = 0
        self.syncs = 0
        self._rr = 0
        self.crashed = [False] * replicas
        self.crash_events: list[dict] = []
        self._retired_seen: dict[int, int] = {}
        self._recovery_pending = False
        self._adopted_this_step = 0
        self.recovered_requests = 0        # reconstructed + re-admitted
        self.recovered_complete = 0        # finished; only the DONE was lost
        self.failed_requests = 0           # exceeded max_retries
        self.lost_requests = 0             # descriptor incomplete (journal)
        self.dup_done_suppressed = 0       # exactly-once dedup hits

    # -- request journal ----------------------------------------------------

    def _journal(self, r: int, kind: str, req: sched_mod.Request) -> None:
        """Engine → journal hook: record decode progress and terminal
        status in replica r's journal lane."""
        store = self.stores[r]
        if kind == "gen":
            store.journal_append(req.rid, J_GEN, len(req.tokens) - 1,
                                 req.tokens[-1])
        elif kind == "done":
            if self._done_logged(store, req.rid):
                self.dup_done_suppressed += 1
            else:
                store.journal_append(req.rid, J_DONE, len(req.tokens))
        elif kind == "shed":
            store.journal_append(req.rid, J_SHED)
        elif kind == "expired":
            store.journal_append(req.rid, J_EXPIRED)

    @staticmethod
    def _done_logged(store: ReplicatedPageStore, rid: int) -> bool:
        return any(t == J_DONE and r == rid
                   for _, r, t, _a, _b in store.journal_entries())

    # -- physical page adoption (prefill/decode disaggregation) -------------

    def arm_transfer_crash(self, exporter: int, after: int = 0) -> None:
        """Chaos hook: crash-stop ``exporter`` in the middle of its
        (``after``+1)-th exported page transfer — after the adopter's
        provisional share and BEGIN journal entry, before the commit check
        — so the epoch re-check must abort and roll the adopter back."""
        self._xfer_crash = (exporter, after)

    def _adopt(self, r: int, rid: int, ctx: list,
               shared: list) -> tuple[list, list, int]:
        """Admission-time adoption hook for decode/mixed replica ``r``.

        Walks the prompt's full-page chain.  Position k's page is, in
        order of preference: the locally shared page if this engine's pool
        already holds its bytes (``filled_seq``); otherwise a peer-published
        page (validated resolve — hash/epoch/owner-live, as
        ``resolve_remote``) whose exporter reports the bytes landed, pulled
        by the rule-3 dance — provisional ``share``, physical
        ``copy_pages_across`` into this engine's pool, then commit iff the
        publishing epoch is unchanged and the exporter survived the
        transfer.  An unfilled local page with no adoptable peer copy
        breaks the covered chain; the remaining locally shared pages are
        kept as plain mapping targets (the admission stream rewrites them
        with identical bytes), exactly as before.  An aborted transfer
        drops the provisional reference and discards the staged bytes: the
        page was never bound to a row, so the adopter state is untouched.
        Every transfer is journaled (BEGIN then COMMIT/ABORT) in this
        replica's lane under the adopting request's rid.

        Returns ``(lead_pages, adopted_pages, covered_tokens)``: the row's
        full leading page chain (every page already ref-held here — kept
        locals are shared by this hook, adopted pages by the rule-3
        commit), the subset that was physically transferred, and how many
        leading prompt positions are physically cached in this pool.
        """
        cache = self.caches[r]
        alloc = self.allocators[r]
        ps = cache.page_size
        lead: list = []
        adopted: list = []
        covered_pages = 0
        chain_live = True
        can_adopt = not alloc.halted and not alloc.fenced(alloc.now)
        n_full = len(ctx) // ps
        for k in range(1, max(n_full, len(shared)) + 1):
            local = shared[k - 1] if k <= len(shared) else None
            if chain_live and local is not None \
                    and cache.filled_seq(local) is not None:
                lead.append(local)
                covered_pages = k
                continue
            if chain_live and can_adopt and k <= n_full:
                page = self._pull_page(r, rid, tuple(ctx[:k * ps]), lead)
                if page is not None:
                    lead.append(page)
                    adopted.append(page)
                    covered_pages = k
                    continue
            chain_live = False
            if local is None:
                break
            lead.append(local)             # mapping-only use past the break
        kept = [p for p in lead if p not in set(adopted)]
        if kept:
            alloc.share(kept)
        return lead, adopted, covered_pages * ps

    def _pull_page(self, r: int, rid: int, key: tuple,
                   lead: list) -> Optional[int]:
        """One rule-3 physical pull for the chain page covering ``key``;
        returns the committed page or None (no adoptable copy / abort).

        The transfer writes this engine's pool in place (JAX's is
        functional and simply drops the new cache on abort), so the rows it
        overwrites — one page row per pool leaf per paged layer — are
        snapshot first and restored on abort: an aborted pull leaves the
        adopter's pool bitwise as it was."""
        eng = self.engines[r]
        cache = self.caches[r]
        store = self.stores[r]
        hit = cache.resolve_remote(key)
        if hit is None:
            return None
        owner, page, seq = hit
        if owner == r or self.crashed[owner] or page in lead:
            return None
        if self.caches[owner].filled_seq(page) != seq:
            return None                    # map entry re-homed mid-write
        self.allocators[r].share([page])
        store.journal_append(rid, J_XFER_BEGIN, page, seq)
        before = cache_mod.export_pages(eng.cache, [page])
        _, nb = cache_mod.copy_pages_across(
            self.engines[owner].cache, eng.cache, [page], impl=self.impl)
        if self._xfer_crash is not None and self._xfer_crash[0] == owner:
            exp, after = self._xfer_crash
            if after <= 0:
                self._xfer_crash = None
                self.crash(owner)          # exporter dies mid-transfer
            else:
                self._xfer_crash = (exp, after - 1)
        if self.crashed[owner] or store.lease(page) != (owner, seq):
            cache_mod.adopt_pages(eng.cache, before, [page], impl=self.impl)
            store.ref_sub(page)            # roll the provisional share back
            store.journal_append(rid, J_XFER_ABORT, page, seq)
            self.adopt_aborts += 1
            return None
        store.journal_append(rid, J_XFER_COMMIT, page, seq)
        cache.mark_filled([page])
        cache.cross_replica_hits += 1
        self.transferred_pages += 1
        self.transfer_bytes += nb
        return page

    # -- request routing ----------------------------------------------------

    def _prefix_published(self, prompt: list) -> bool:
        """Routing probe: does any live replica's view publish this
        prompt's first full page?  (Unvalidated — a routing heuristic, not
        an adoption decision.)"""
        ps = self.caches[0].page_size
        if len(prompt) < ps:
            return False
        h = prefix_hash(tuple(prompt[:ps]))
        return any(self.stores[r].lookup_prefix(h) is not None
                   for r in range(self.replicas) if not self.crashed[r])

    def _accept(self, r: int, req: sched_mod.Request) -> int:
        store = self.stores[r]
        store.journal_append(
            req.rid, J_ACCEPT,
            (len(req.prompt) << 16) | req.max_new_tokens,
            0 if req.eos_id is None else req.eos_id + 1)
        for i, t in enumerate(req.prompt):
            store.journal_append(req.rid, J_PROMPT, i, t)
        self.engines[r].submit(req)
        return r

    def submit(self, req: sched_mod.Request) -> int:
        """Dispatch a request to a live replica; journals the descriptor in
        the accepting replica's lane.  Returns the replica.

        All-mixed topology: plain round-robin.  Disaggregated topology:
        cold prompts (no replica publishes their first page yet) go to
        prefill-role replicas, warm prompts to decode-role replicas — whose
        adoption hook pulls the published pages — with mixed replicas as
        second choice and any live replica as the last resort, so a
        one-sided crash degrades to the old behavior instead of rejecting.
        """
        if all(role == "mixed" for role in self.roles):
            for _ in range(self.replicas):
                r = self._rr
                self._rr = (self._rr + 1) % self.replicas
                if self.crashed[r] or self.allocators[r].halted:
                    continue
                return self._accept(r, req)
            raise RuntimeError("no live replica to accept the request")
        want = ("decode" if self._prefix_published(req.prompt)
                else "prefill")
        tiers = ([r for r in range(self.replicas) if self.roles[r] == want],
                 [r for r in range(self.replicas)
                  if self.roles[r] == "mixed"],
                 [r for r in range(self.replicas)
                  if self.roles[r] not in (want, "mixed")])
        start = self._rr
        self._rr += 1
        for tier in tiers:
            for i in range(len(tier)):
                r = tier[(start + i) % len(tier)]
                if self.crashed[r] or self.allocators[r].halted:
                    continue
                return self._accept(r, req)
        raise RuntimeError("no live replica to accept the request")

    # -- gossip through the channel -----------------------------------------

    def _pump(self, now: int) -> None:
        """Deliver everything the channel has due: delta packets go to the
        destination node (its ack rides the channel back), acks advance the
        sender's frontier.  Packets addressed to a crashed replica drop on
        the floor — exactly what a dead process does."""
        progressed = True
        while progressed:
            progressed = False
            for pkt in self.channel.deliver(now):
                progressed = True
                if self.crashed[pkt.dst]:
                    continue
                node = self.nodes[pkt.dst]
                if isinstance(pkt, AckPacket):
                    node.receive_ack(pkt, now)
                else:
                    self.channel.send(node.receive(pkt, now), now)

    def sync(self) -> None:
        """One all-to-all gossip round through the channel.  Reliable
        channel: packets and acks deliver in order, same tick — bit-
        identical to the pre-channel reliable sync.  Faulty channel:
        this round's packets land on later ticks (min delay 1), earlier
        rounds' survivors land now."""
        now = self.clock
        self._pump(now)
        for src in range(self.replicas):
            if self.crashed[src] or self.allocators[src].halted:
                continue
            node = self.nodes[src]
            retired = self.stores[src].retired_mask()
            for dst in node.acked:
                if retired[dst]:
                    continue               # no point gossiping to the dead
                self.channel.send(node.make_packet(dst, now), now)
        self._pump(now)
        for r in range(self.replicas):
            if not self.crashed[r]:
                self.allocators[r].scavenge()
        self.syncs += 1

    # -- crash failover -----------------------------------------------------

    def crash(self, r: int) -> None:
        """Crash-stop replica r: it stops stepping, heartbeating and
        gossiping, and every packet addressed to it is dropped.  Recovery
        rides the retirement protocol; see the class docstring."""
        if self.crashed[r]:
            return
        self.crashed[r] = True
        self.crash_events.append({"replica": r, "step": self.clock})
        live = self.replicas - sum(self.crashed)
        if live >= self.stores[0].majority:
            self._recovery_pending = True

    @staticmethod
    def _contiguous(entries: dict[int, int]) -> list[int]:
        """Longest gap-free run of journaled (index → value) from 0."""
        out: list[int] = []
        while len(out) in entries:
            out.append(entries[len(out)])
        return out

    def _fold_journal(self, store: ReplicatedPageStore) -> dict[int, dict]:
        """Merge the journal into per-request descriptors.  The owner is
        the ACCEPT lane until an ADOPT supersedes it (highest retry count
        wins — lanes are scanned in id order, not arrival order)."""
        info: dict[int, dict] = {}
        for lane, rid, tag, a, b in store.journal_entries():
            d = info.setdefault(rid, {
                "accept_lane": None, "adopt_lane": None, "retries": 0,
                "plen": 0, "max_new": 0, "eos": None,
                "prompt": {}, "gen": {}, "terminal": False})
            if tag == J_ACCEPT:
                d["accept_lane"] = lane
                d["plen"] = a >> 16
                d["max_new"] = a & 0xFFFF
                d["eos"] = b - 1 if b > 0 else None
            elif tag == J_PROMPT:
                d["prompt"][a] = b
            elif tag == J_GEN:
                d["gen"][a] = b
            elif tag == J_ADOPT:
                if a >= d["retries"]:
                    d["adopt_lane"], d["retries"] = lane, a
            elif tag in (J_DONE, J_SHED, J_EXPIRED, J_FAIL):
                d["terminal"] = True
        for d in info.values():
            d["owner"] = (d["adopt_lane"] if d["adopt_lane"] is not None
                          else d["accept_lane"])
        return info

    def _recover(self) -> None:
        """Adopt a retired replica's unfinished requests.  Runs on the
        lowest live replica's view only (a single deterministic adopter,
        like page re-homing), after retirement has been observed for
        ``adopt_grace`` ticks so the crashed lane's journal entries have
        converged across survivors."""
        live = [r for r in range(self.replicas)
                if not self.crashed[r] and not self.allocators[r].halted]
        if not live:
            self._recovery_pending = False
            return
        adopter = live[0]
        store = self.stores[adopter]
        retired = store.retired_mask()
        crashed = [r for r in range(self.replicas) if self.crashed[r]]
        if not all(retired[r] for r in crashed):
            return                         # retirement votes still in flight
        for r in crashed:
            self._retired_seen.setdefault(r, self.clock)
        if any(self.clock - self._retired_seen[r] < self.adopt_grace
               for r in crashed):
            return                         # journal still converging
        engine = self.engines[adopter]
        info = self._fold_journal(store)
        adopted = 0
        for rid in sorted(info):
            d = info[rid]
            if (d["owner"] is None or not retired[d["owner"]]
                    or d["terminal"]):
                continue
            prompt = self._contiguous(d["prompt"])
            gen = self._contiguous(d["gen"])
            if len(prompt) != d["plen"] or d["max_new"] < 1:
                store.journal_append(rid, J_FAIL)   # descriptor incomplete
                self.lost_requests += 1
                continue
            retries = d["retries"] + 1
            if retries > self.max_retries:
                store.journal_append(rid, J_FAIL)
                self.failed_requests += 1
                continue
            store.journal_append(rid, J_ADOPT, retries)
            req = sched_mod.Request(rid=rid, prompt=prompt,
                                    max_new_tokens=d["max_new"],
                                    eos_id=d["eos"])
            req.tokens = list(gen)
            req.retries = retries
            if (len(gen) >= d["max_new"]
                    or (d["eos"] is not None and gen
                        and gen[-1] == d["eos"])):
                # Finished on the crashed replica; only the DONE was lost.
                req.status = sched_mod.COMPLETED
                store.journal_append(rid, J_DONE, len(gen))
                self.recovered_complete += 1
                continue
            engine.submit(req)
            req.retry_at = engine.stats["steps"] + \
                engine_mod.backoff_steps(rid, retries)
            self.recovered_requests += 1
            adopted += 1
        self._recovery_pending = False
        self._adopted_this_step = adopted

    # -- serve loop ---------------------------------------------------------

    def step(self) -> bool:
        more = False
        for r, e in enumerate(self.engines):
            if not self.crashed[r]:
                more = e.step() or more
        self.clock += 1
        for r, alloc in enumerate(self.allocators):
            if not self.crashed[r]:
                alloc.maintain(self.clock)
        if self.clock % self.sync_every == 0:
            self.sync()
        self._adopted_this_step = 0
        if self._recovery_pending:
            self._recover()
        # Adoption re-enqueues work AFTER the engines stepped — the step
        # that adopts must report progress or the serve loop would exit
        # with the recovered requests still queued.
        return more or self._recovery_pending or self._adopted_this_step > 0

    def run(self, requests: list[sched_mod.Request],
            max_steps: int = 100_000) -> list[sched_mod.Request]:
        for req in requests:
            self.submit(req)
        for _ in range(max_steps):
            if not self.step():
                break
        else:
            raise RuntimeError("multi-engine serve hit max_steps")
        self.sync()                        # final round: frontiers settle
        return requests

    @property
    def sync_bytes(self) -> int:
        return sum(node.bytes_sent for node in self.nodes)

    def stats(self) -> dict:
        out = {"replicas": self.replicas, "steps": self.clock,
               "syncs": self.syncs, "sync_bytes": self.sync_bytes,
               "sync_bytes_per_step": (self.sync_bytes // self.clock
                                       if self.clock else 0),
               "cross_replica_hits": sum(c.cross_replica_hits
                                         for c in self.caches),
               "published_prefix_pages": sum(c.published
                                             for c in self.caches),
               "crashes": len(self.crash_events),
               "recovered_requests": self.recovered_requests,
               "recovered_complete": self.recovered_complete,
               "failed_requests": self.failed_requests,
               "lost_requests": self.lost_requests,
               "dup_done_suppressed": self.dup_done_suppressed,
               "transferred_pages": self.transferred_pages,
               "transfer_bytes": self.transfer_bytes,
               "adopt_aborts": self.adopt_aborts}
        for key in ("admitted", "completed", "gen_tokens", "prefill_tokens",
                    "shared_pages", "cow_copies", "preemptions",
                    "prefill_chunks", "decode_stall_steps",
                    "shed", "expired", "retried", "preempt_fenced",
                    "adopted_pages", "adopted_tokens",
                    "prefill_steps_avoided"):
            out[key] = sum(e.stats[key] for e in self.engines)
        return out

    def converged(self) -> bool:
        """Bitwise page-table agreement across live (non-crashed,
        non-halted) replicas."""
        stores = [s for r, s in enumerate(self.stores)
                  if not self.crashed[r] and not self.allocators[r].halted]
        if not stores:
            return True
        d0 = stores[0].digest()
        return all(s.digest() == d0 for s in stores[1:])


class ReplicatedPrefixPageMapper:
    """``PrefixPageMapper`` over a replicated page table (orchestrator
    ``--replicas N``).

    Agent rows are partitioned round-robin across N metadata replicas, each
    owning a home slice of ONE physical page pool (the agents still share a
    single batched engine, so page ids are globally meaningful).  Because
    the pool is physically shared, a validated remote prefix hit is adopted
    for REAL here: the row's block table points straight at the peer-owned
    page while this replica's counter lane holds the share — the in-process
    degenerate case of protocol rule 3, where the provisional share commits
    immediately because the lease epoch is re-read in the same tick.
    Replicas gossip at every coordination sync (``gossip()``), so
    cross-replica hits only appear once a peer's publication has shipped —
    exactly the observation-driven coordination the paper measures, applied
    to the serving plane.
    """

    def __init__(self, num_rows: int, maxp: int, page_size: int,
                 trash_page: int, *, replicas: int = 2,
                 num_pages: Optional[int] = None,
                 delta_capacity: int = 32, disaggregate: bool = False):
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        if disaggregate and replicas < 2:
            raise ValueError("disaggregate requires >= 2 metadata replicas "
                             "(one prefill home + decode homes)")
        num_pages = (num_rows + replicas) * maxp if num_pages is None \
            else num_pages
        if trash_page < num_pages:
            raise ValueError(
                f"trash_page {trash_page} lies inside the allocatable pool "
                f"[0, {num_pages})")
        self.replicas = replicas
        self.page_size = page_size
        self.maxp = maxp
        self.trash_page = trash_page
        self.stores = [ReplicatedPageStore(r, replicas, num_pages)
                       for r in range(replicas)]
        gossip = None
        self.nodes, self.allocators, self.caches = [], [], []
        for store in self.stores:
            node = AntiEntropyNode(store, capacity=delta_capacity,
                                   gossip=gossip)
            gossip = node.gossip
            alloc = ReplicatedPageAllocator(store, ttl=4, linger=0)
            self.nodes.append(node)
            self.allocators.append(alloc)
            self.caches.append(ReplicatedPrefixCache(alloc, page_size))
        self.host_bt = np.full((num_rows, maxp), trash_page, np.int32)
        self._row_pages: list[list[int]] = [[] for _ in range(num_rows)]
        self.shared_pages = 0
        self.cross_replica_hits = 0
        self.disaggregate = disaggregate
        self.now = 0
        self._dirty = True

    def _domain(self, row: int) -> int:
        # Disaggregated homing (orchestrator ``--disaggregate``): agent 0 —
        # the first to map the shared task header — homes on the prefill
        # domain 0 and publishes the header chain; every other agent homes
        # on a decode domain, so its header hits are cross-replica
        # adoptions of domain 0's filled pages rather than same-domain
        # local shares.  Default: round-robin.
        if self.disaggregate:
            return 0 if row == 0 else 1 + (row - 1) % (self.replicas - 1)
        return row % self.replicas

    def map_row(self, row: int, tokens: list[int], horizon: int) -> int:
        """Remap ``row``: longest local prefix run, then validated remote
        adoption for chain pages published by peers, fresh home pages for
        the rest.  Returns the number of shared (local + adopted) pages."""
        d = self._domain(row)
        alloc, cache = self.allocators[d], self.caches[d]
        ps = self.page_size
        npages = min(-(-horizon // ps), self.maxp)
        n_write = len(tokens) // ps       # decode writes from page n_write
        local = sched_mod.PrefixCache.lookup(cache, tokens,
                                             boundary=False)[:n_write]
        alloc.share(local)
        adopted: list[int] = []
        for k in range(len(local) + 1, n_write + 1):
            hit = cache.resolve_remote(tuple(tokens[:k * ps]))
            if hit is None or hit[0] == d:
                break
            owner, page, seq = hit
            alloc.share([page])            # provisional...
            if cache.store.lease(page) != (owner, seq):
                cache.store.ref_sub(page)  # ...epoch moved: abort
                break
            adopted.append(page)           # ...same tick: commit
            self.cross_replica_hits += 1
        shared = local + adopted
        fresh = alloc.alloc(npages - len(shared))
        if fresh is None:
            alloc.free(shared)
            raise RuntimeError("agent page pool exhausted")
        pages = shared + fresh
        old = self._row_pages[row]
        self._row_pages[row] = pages
        self.host_bt[row, :] = self.trash_page
        self.host_bt[row, :len(pages)] = pages
        if old:
            alloc.free(old)               # after remap: self-prefix shares
        cache.register(tokens[:n_write * ps], pages[:n_write])
        # The pool is physically shared and the row replays its own prompt
        # through the serve step, so the chain's bytes land in place —
        # mark filled here to flush the deferred (publish-on-fill)
        # publication for the pages this domain owns.
        cache.mark_filled(pages[:n_write])
        if self.disaggregate and d == 0 and n_write:
            # Prefill tier notifies on fill (as a disaggregated deployment
            # would): push the publication to the decode homes eagerly so
            # their very next map can adopt instead of re-allocating.
            self.gossip()
        self.shared_pages += len(shared)
        self._dirty = True
        return len(shared)

    def free_row(self, row: int) -> None:
        if self._row_pages[row]:
            self.allocators[self._domain(row)].free(self._row_pages[row])
            self._row_pages[row] = []
        self.host_bt[row, :] = self.trash_page
        self._dirty = True

    def install(self, cache):
        """Install the host block table into ``cache`` iff it changed since
        the last install."""
        if self._dirty:
            cache = cache_mod.set_block_tables(
                cache, torch.from_numpy(self.host_bt.copy()))
            self._dirty = False
        return cache

    def gossip(self) -> None:
        """One reliable all-to-all anti-entropy round (same tick)."""
        self.now += 1
        for alloc in self.allocators:
            alloc.now = self.now
            alloc.maintain(self.now)
        for src in range(self.replicas):
            for dst in range(self.replicas):
                if src == dst:
                    continue
                pkt = self.nodes[src].make_packet(dst, self.now)
                ack = self.nodes[dst].receive(pkt, self.now)
                self.nodes[src].receive_ack(ack, self.now)
        for alloc in self.allocators:
            alloc.scavenge()

    @property
    def sync_bytes(self) -> int:
        return sum(node.bytes_sent for node in self.nodes)

    def converged(self) -> bool:
        d0 = self.stores[0].digest()
        return all(s.digest() == d0 for s in self.stores[1:])
