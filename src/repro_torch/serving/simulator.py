"""Deterministic fault-injecting replica simulator for the replicated page
table (serving/replicated.py).

N simulated engine replicas drive the REAL protocol objects —
``ReplicatedPageStore`` + ``ReplicatedPageAllocator`` +
``ReplicatedPrefixCache`` + ``AntiEntropyNode`` — through a seeded schedule
of admit / grow / preempt / complete / crash events, while every gossip
packet (deltas AND acks) crosses a ``FaultyChannel`` that can drop,
duplicate, delay, reorder, and partition.  Pages here are abstract (no
model, no KV bytes), which is exactly what lets the simulator exercise the
provisional-share protocol at page-table granularity under every fault
schedule (the engine path adopts real pages over a reliable channel).

After the event horizon the simulator *quiesces*: faults stop, the channel
drains, and replicas keep gossiping until their page tables agree.  Then it
checks the three contracts the distributed tier sells:

  convergence   every live replica's CRDT state is BITWISE identical, and
                identical to the full fold-join of all live states
                (``merge.fold_join`` — the oracle the delta path must match).
  conservation  per lane and per page: replica r's lane value equals the
                references r's live requests (plus frozen crash holdings)
                actually hold — no leak, no double-free (``dec <= inc``
                cellwise), no cross-replica aliasing without a share.
  lease safety  at no point did two live replicas hold an open write
                session on the same page (checked online by ``Monitor``,
                not post-hoc).

Every run emits a JSON-able convergence trace (per-round digests, events,
violations).  The protocol objects are the port's, host code over numpy
state with the delta engine on CPU tensors; nothing here touches a card.
Run standalone:

    PYTHONPATH=src python -m repro_torch.serving.simulator \
        --replicas 4 --seed 0 --schedule partition_heal --trace t.json
"""
from __future__ import annotations

import argparse
import heapq
import json
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import merge as merge_mod
from repro_torch.core import tree as tree_mod
from repro_torch.serving.replicated import (AckPacket, AntiEntropyNode,
                                            ReplicatedPageAllocator,
                                            ReplicatedPageStore,
                                            ReplicatedPrefixCache)

# ---------------------------------------------------------------------------
# Fault model
# ---------------------------------------------------------------------------


@dataclass
class FaultSpec:
    """Adversarial channel behaviour, all driven by the run's seeded RNG.

    ``partitions`` entries are ``(t0, t1, side)``: during [t0, t1) packets
    between ``side`` and its complement are dropped (both directions).
    ``crash`` maps replica -> crash step (crash-stop: no further ops,
    heartbeats, or packets)."""

    drop: float = 0.0
    dup: float = 0.0
    delay_max: int = 0          # extra delivery delay, uniform in [0, max]
    reorder: float = 0.0        # probability of +[1, 3] extra delay
    partitions: list = field(default_factory=list)
    crash: dict = field(default_factory=dict)


SCHEDULES: dict[str, FaultSpec] = {
    "lossy": FaultSpec(drop=0.3, dup=0.3),
    "reorder_delay": FaultSpec(dup=0.15, delay_max=3, reorder=0.5),
    "partition_heal": FaultSpec(drop=0.1,
                                partitions=[(12, 34, frozenset({0}))]),
    "crash_reclaim": FaultSpec(drop=0.15, crash={1: 18}),
}


class FaultyChannel:
    """Deterministic unreliable transport for gossip packets."""

    def __init__(self, rng: np.random.Generator, spec: FaultSpec):
        self.rng = rng
        self.spec = spec
        self.healed = False
        self._q: list = []          # heap of (deliver_at, seqno, packet)
        self._seq = 0
        self.sent = 0
        self.dropped = 0
        self.duplicated = 0

    def _partitioned(self, a: int, b: int, now: int) -> bool:
        if self.healed:
            return False
        for t0, t1, side in self.spec.partitions:
            if t0 <= now < t1 and ((a in side) != (b in side)):
                return True
        return False

    def send(self, pkt: Any, now: int) -> None:
        self.sent += 1
        if self._partitioned(pkt.src, pkt.dst, now):
            self.dropped += 1
            return
        if not self.healed and self.rng.random() < self.spec.drop:
            self.dropped += 1
            return
        copies = 1
        if not self.healed and self.rng.random() < self.spec.dup:
            copies = 2
            self.duplicated += 1
        for _ in range(copies):
            delay = 1
            if not self.healed:
                if self.spec.delay_max:
                    delay += int(self.rng.integers(0,
                                                   self.spec.delay_max + 1))
                if self.spec.reorder and self.rng.random() < self.spec.reorder:
                    delay += int(self.rng.integers(1, 4))
            heapq.heappush(self._q, (now + delay, self._seq, pkt))
            self._seq += 1

    def deliver(self, now: int) -> list:
        out = []
        while self._q and self._q[0][0] <= now:
            _, _, pkt = heapq.heappop(self._q)
            out.append(pkt)
        return out

    @property
    def in_flight(self) -> int:
        return len(self._q)


# ---------------------------------------------------------------------------
# Lease-safety monitor (online, global observer)
# ---------------------------------------------------------------------------


class Monitor:
    """Tracks open write sessions per page and flags dual live writers.

    A session opens at a replica's first write to a page it allocated and
    closes when that replica releases the page (or crashes — a crashed
    writer cannot race anyone).  A write by X while Y != X holds an open
    session AND is still live is a lease violation: two live owners wrote
    the same physical page."""

    def __init__(self):
        self.open: dict[int, tuple[int, int]] = {}    # page -> (rid, seq)
        self.violations: list[dict] = []
        self.writes = 0

    def on_write(self, rid: int, page: int, seq: int, now: int,
                 live) -> None:
        self.writes += 1
        cur = self.open.get(page)
        if cur is not None and cur[0] != rid and live(cur[0]):
            self.violations.append(
                {"page": page, "now": now, "writer": rid,
                 "writer_seq": seq, "holder": cur[0], "holder_seq": cur[1]})
        self.open[page] = (rid, seq)

    def on_release(self, rid: int, page: int) -> None:
        if self.open.get(page, (None,))[0] == rid:
            del self.open[page]


# ---------------------------------------------------------------------------
# Simulated replica
# ---------------------------------------------------------------------------


@dataclass
class SimRequest:
    rid: int                    # request id (globally unique)
    prompt_id: int
    n_prompt: int               # prompt pages (shareable, written once)
    grow_left: int              # private growth pages still to allocate
    shared: list = field(default_factory=list)
    owned: list = field(default_factory=list)

    @property
    def held(self) -> list:
        return self.shared + self.owned


class SimReplica:
    """One engine replica at page-table granularity.

    Prompt pages are shareable: the first replica to admit a prompt
    allocates + writes + publishes them; later admissions share — locally
    with an immediate commit, cross-replica through the provisional
    protocol (share lane → wait to hear from the owner → commit iff the
    lease epoch is unchanged, else abort).  Growth pages are private and
    written by their owner every allocation — the write stream the lease
    monitor audits."""

    ADOPT_TTL = 12              # abort provisional adoptions unheard this long

    def __init__(self, rid: int, store: ReplicatedPageStore,
                 node: AntiEntropyNode, allocator: ReplicatedPageAllocator,
                 monitor: Monitor, live):
        self.rid = rid
        self.store = store
        self.node = node
        self.allocator = allocator
        self.cache = ReplicatedPrefixCache(allocator, page_size=1)
        self.monitor = monitor
        self.live = live
        self.requests: dict[int, SimRequest] = {}
        self.requeue: list[tuple[int, int, int]] = []
        self.pending_adopt: dict[int, tuple[int, SimRequest, int, int]] = {}
        self.crashed = False
        self.frozen_holdings: Optional[dict[int, int]] = None
        self.counters = {"admitted": 0, "admit_failed": 0, "completed": 0,
                         "preempted": 0, "grown": 0, "grow_starved": 0,
                         "adopt_committed": 0, "adopt_aborted": 0,
                         "local_shares": 0, "fenced_skips": 0}

    # -- bookkeeping ---------------------------------------------------------

    def holdings(self) -> dict[int, int]:
        """page -> references this replica's lane should hold right now."""
        held: dict[int, int] = {}
        for req in self.requests.values():
            for p in req.held:
                held[p] = held.get(p, 0) + 1
        for p in self.pending_adopt:
            held[p] = held.get(p, 0) + 1
        return held

    def _write(self, page: int, now: int) -> None:
        _, seq = self.store.lease(page)
        self.monitor.on_write(self.rid, page, seq, now, self.live)

    def _release_pages(self, req: SimRequest) -> None:
        for p in req.owned:
            self.monitor.on_release(self.rid, p)
        self.allocator.free(req.held)

    # -- events --------------------------------------------------------------

    def admit(self, job: tuple[int, int, int], now: int) -> bool:
        if self.allocator.halted or self.allocator.fenced(now):
            self.counters["fenced_skips"] += 1
            self.requeue.append(job)
            return False
        rid_req, prompt_id, n_prompt = job[0], job[1], job[2]
        grow = job[3] if len(job) > 3 else 0
        req = SimRequest(rid=rid_req, prompt_id=prompt_id,
                         n_prompt=n_prompt, grow_left=grow)
        for k in range(1, n_prompt + 1):
            key = (prompt_id, k)
            hit = self.cache.resolve_remote(key)
            if hit is not None:
                owner, page, seq = hit
                if owner == self.rid:
                    self.allocator.share([page])
                    req.shared.append(page)
                    self.counters["local_shares"] += 1
                    continue
                if page not in self.pending_adopt:
                    self.allocator.share([page])
                    self.pending_adopt[page] = (seq, req, now, owner)
                    continue
            pages = self.allocator.alloc(1)
            if pages is None:
                # Roll back and retry later (admission is all-or-nothing
                # for the pages we DID take; pending adoptions stay in
                # flight and resolve to an already-dead request → abort).
                self._rollback(req)
                self.counters["admit_failed"] += 1
                self.requeue.append(job)
                return False
            p = pages[0]
            req.owned.append(p)
            self._write(p, now)
            # The abstract write above already landed the page's bytes, so
            # publication is immediate (publish-on-fill, as the engine path).
            self.cache.mark_filled([p])
            self.cache._publish_page(key, p)
        self.requests[req.rid] = req
        self.counters["admitted"] += 1
        return True

    def _rollback(self, req: SimRequest) -> None:
        for p in req.owned:
            self.monitor.on_release(self.rid, p)
        self.allocator.free(req.held)
        drop = [p for p, (_, r, _, _) in self.pending_adopt.items()
                if r is req]
        for p in drop:
            del self.pending_adopt[p]
            self.store.ref_sub(p)
            self.counters["adopt_aborted"] += 1

    def grow(self, now: int) -> None:
        if self.allocator.halted or self.allocator.fenced(now):
            self.counters["fenced_skips"] += 1
            return
        for req in sorted(self.requests.values(), key=lambda r: r.rid):
            if req.grow_left <= 0:
                continue
            pages = self.allocator.alloc(1)
            if pages is None:
                self.counters["grow_starved"] += 1
                return
            req.owned.append(pages[0])
            req.grow_left -= 1
            self._write(pages[0], now)
            self.counters["grown"] += 1
            return                        # one growth per event

    def complete(self) -> None:
        if not self.requests:
            return
        rid = min(self.requests)          # FIFO-ish, deterministic
        req = self.requests.pop(rid)
        self._release_pages(req)
        self.counters["completed"] += 1

    def preempt(self) -> None:
        if not self.requests:
            return
        rid = max(self.requests)          # youngest, deterministic
        req = self.requests.pop(rid)
        self._release_pages(req)
        # Re-queued with its remaining growth folded back in.
        self.requeue.append((req.rid, req.prompt_id, req.n_prompt,
                             req.grow_left))
        self.counters["preempted"] += 1

    def crash(self) -> None:
        self.crashed = True
        # Frozen holdings: the references this lane will hold forever unless
        # the replica is retired (then the lane is masked out entirely).
        self.frozen_holdings = self.holdings()

    # -- per-step protocol work ----------------------------------------------

    def resolve_adoptions(self, now: int) -> None:
        for page in sorted(self.pending_adopt):
            seq, req, t0, owner = self.pending_adopt[page]
            cur_owner, cur_seq = self.store.lease(page)
            epoch_ok = (cur_owner, cur_seq) == (owner, seq)
            # The request may have completed / been preempted while the
            # adoption was in flight — commit-to-dead would leak the ref.
            req_live = self.requests.get(req.rid) is req
            if not epoch_ok or not req_live \
                    or now - t0 > self.ADOPT_TTL:
                del self.pending_adopt[page]
                self.store.ref_sub(page)
                self.counters["adopt_aborted"] += 1
            elif self.store.last_heard.get(owner, 0) > t0:
                del self.pending_adopt[page]
                req.shared.append(page)
                self.counters["adopt_committed"] += 1


# ---------------------------------------------------------------------------
# The simulator proper
# ---------------------------------------------------------------------------


class Simulator:
    """Drives N replicas through a seeded event schedule over a faulty
    channel, then quiesces and checks the distributed contracts."""

    def __init__(self, *, replicas: int = 2, num_pages: int = 48,
                 seed: int = 0, schedule: str = "lossy",
                 steps: int = 40, ttl: int = 6, capacity: int = 24,
                 prompt_pool: int = 4, linger: int = 4):
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {schedule!r}; "
                             f"choose from {sorted(SCHEDULES)}")
        self.n = replicas
        self.num_pages = num_pages
        self.seed = seed
        self.schedule = schedule
        self.steps = steps
        self.ttl = ttl
        self.spec = SCHEDULES[schedule]
        self.rng = np.random.default_rng(seed)
        self.channel = FaultyChannel(np.random.default_rng(seed + 1),
                                     self.spec)
        self.monitor = Monitor()
        self.now = 0
        self._next_req = 0
        self.trace: dict = {"config": {
            "replicas": replicas, "num_pages": num_pages, "seed": seed,
            "schedule": schedule, "steps": steps, "ttl": ttl,
            "capacity": capacity}, "events": [], "rounds": [],
            "violations": []}

        self.stores = [ReplicatedPageStore(r, replicas, num_pages)
                       for r in range(replicas)]
        gossip = None
        self.nodes = []
        for st in self.stores:
            node = AntiEntropyNode(st, capacity=capacity, gossip=gossip)
            gossip = node.gossip
            self.nodes.append(node)
        self.allocs = [ReplicatedPageAllocator(st, ttl=ttl, linger=linger)
                       for st in self.stores]
        self.reps = [SimReplica(r, self.stores[r], self.nodes[r],
                                self.allocs[r], self.monitor, self._is_live)
                     for r in range(replicas)]

    # -- helpers -------------------------------------------------------------

    def _is_live(self, rid: int) -> bool:
        """Crashed OR halted replicas are out of the membership: a halted
        replica was retired by a majority (e.g. after a long partition) and
        fenced itself strictly before retirement was reachable (ttl <
        2*ttl), so like a crashed node it will never write again and is
        excluded from convergence, settlement, and lease-liveness checks."""
        rep = self.reps[rid]
        return not rep.crashed and not rep.allocator.halted

    def live_rids(self) -> list[int]:
        return [r for r in range(self.n) if self._is_live(r)]

    def _log_event(self, rid: int, kind: str, **kw) -> None:
        self.trace["events"].append({"t": self.now, "rid": rid,
                                     "op": kind, **kw})

    # -- one step ------------------------------------------------------------

    def _deliver(self) -> None:
        for pkt in self.channel.deliver(self.now):
            if self.reps[pkt.dst].crashed:
                continue
            node = self.nodes[pkt.dst]
            if isinstance(pkt, AckPacket):
                node.receive_ack(pkt, self.now)
            else:
                ack = node.receive(pkt, self.now)
                self.channel.send(ack, self.now)

    def _gossip(self) -> None:
        for r in self.live_rids():
            for peer in range(self.n):
                if peer == r:
                    continue
                self.channel.send(self.nodes[r].make_packet(peer, self.now),
                                  self.now)

    def _replica_step(self, rep: SimReplica) -> None:
        rep.resolve_adoptions(self.now)
        rep.allocator.maintain(self.now)
        rep.allocator.scavenge()

    def step(self, events: Optional[list] = None) -> None:
        """One simulated tick: deliver → apply events → protocol upkeep →
        gossip.  ``events`` is a list of (rid, op, args) tuples."""
        self._deliver()
        for rid, op, args in (events or []):
            rep = self.reps[rid]
            if rep.crashed:
                continue
            if op == "crash":
                rep.crash()
                self._log_event(rid, "crash")
                continue
            if op == "admit":
                job = rep.requeue.pop(0) if rep.requeue else args
                ok = rep.admit(job, self.now)
                self._log_event(rid, "admit", job=list(job), ok=ok)
            elif op == "grow":
                rep.grow(self.now)
            elif op == "complete":
                rep.complete()
            elif op == "preempt":
                rep.preempt()
        for r in self.live_rids():
            self._replica_step(self.reps[r])
        self._gossip()
        self.now += 1

    # -- schedule generation -------------------------------------------------

    def _draw_events(self) -> list:
        evs = []
        for rid in range(self.n):
            if self.spec.crash.get(rid) == self.now:
                evs.append((rid, "crash", None))
                continue
            u = self.rng.random()
            if u < 0.30:
                job = (self._next_req, int(self.rng.integers(
                    0, 4)), int(self.rng.integers(1, 4)),
                    int(self.rng.integers(0, 3)))
                self._next_req += 1
                evs.append((rid, "admit", job))
            elif u < 0.60:
                evs.append((rid, "grow", None))
            elif u < 0.78:
                evs.append((rid, "complete", None))
            elif u < 0.86:
                evs.append((rid, "preempt", None))
        return evs

    # -- run + quiesce -------------------------------------------------------

    def run(self) -> dict:
        for _ in range(self.steps):
            self.step(self._draw_events())
        self.drain()
        self.quiesce()
        result = self.check_invariants()
        self.trace["result"] = result
        self.trace["violations"] = self.monitor.violations
        return result

    def drain(self) -> None:
        """Retire all live requests so page tables can reach refcount 0."""
        for r in self.live_rids():
            rep = self.reps[r]
            rep.requeue.clear()
            while rep.requests and not rep.allocator.halted:
                self.step([(r, "complete", None)])

    def quiesce(self, max_rounds: Optional[int] = None) -> None:
        """Heal all faults, finish pending protocol work, then freeze
        liveness traffic and flush gossip until live replicas are BITWISE
        identical.

        Two phases because heartbeats are *designed* to never converge: every
        ``maintain`` bumps the local counter, so each replica is always one
        gossip hop behind its peers' latest beat.  Phase A runs the full
        protocol (heartbeats, retirement votes, reclamation) until no replica
        has pending work; phase B stops calling ``maintain`` — freezing the
        heartbeat lattice — and alternates gossip rounds with channel drains
        until every array, heartbeats included, matches exactly."""
        self.channel.healed = True
        if max_rounds is None:
            # Long enough for crash retirement (hb stale > 2*ttl) plus the
            # reclamation grace window, with slack for gossip catch-up.
            max_rounds = 4 * self.ttl + 40
        # Phase A — active protocol until no pending work anywhere.
        settled_at = None
        for _ in range(max_rounds):
            self.step()
            if self._work_settled():
                settled_at = self.now
                break
        if settled_at is None:
            raise AssertionError(
                f"protocol work never settled after {max_rounds} rounds")
        # Phase B — liveness frozen; flush deltas to bitwise convergence.
        flush_cap = 4 * self.num_pages + 40
        for _ in range(flush_cap):
            self._drain_channel()
            digests = sorted({self.stores[r].digest()
                              for r in self.live_rids()})
            self.trace["rounds"].append(
                {"t": self.now, "digests": [d[:16] for d in digests]})
            if len(digests) == 1:
                return
            self._gossip()
            self.now += 1
        raise AssertionError(
            f"no bitwise convergence after {flush_cap} flush rounds: "
            f"digests={[self.stores[r].digest()[:8] for r in self.live_rids()]}")

    def _work_settled(self) -> bool:
        for r in self.live_rids():
            rep = self.reps[r]
            if rep.pending_adopt or rep.allocator._claims \
                    or rep.allocator._cooling or rep.requests:
                return False
        return True

    def _drain_channel(self) -> None:
        """Deliver every in-flight packet (including acks spawned by those
        deliveries) without generating new gossip."""
        while self.channel.in_flight:
            self.now += 1
            self._deliver()

    # -- invariants ----------------------------------------------------------

    def check_invariants(self) -> dict:
        live = self.live_rids()
        failures = []

        # 1. Bitwise convergence across live replicas.
        digests = [self.stores[r].digest() for r in live]
        if len(set(digests)) != 1:
            failures.append(f"divergent digests: {digests}")

        # 2. Delta path matches the full fold-join oracle.
        states = [self.stores[r].state() for r in live]
        oracle = merge_mod.fold_join(states)
        for r, st in zip(live, states):
            same = all(bool(torch.equal(a, b)) for a, b in zip(
                tree_mod.leaves(st), tree_mod.leaves(oracle)))
            if not same:
                failures.append(f"replica {r} != fold_join oracle")

        # 3. No double-free anywhere: dec <= inc cellwise (merged view).
        ref = self.stores[live[0]]
        if not (ref.dec <= ref.inc).all():
            failures.append("dec > inc: double-free in merged counter state")

        # 4. Per-lane conservation: each lane's refcount total equals the
        #    references that replica's live requests actually hold (frozen
        #    snapshot for crashed-but-unretired lanes; retired lanes are
        #    excluded from refcounts entirely).  Each lane is audited against
        #    its OWN replica's store — lanes are single-writer, so that copy
        #    is authoritative even when a crash lost the final deltas.
        retired = ref.retired_mask()
        for r in range(self.n):
            own = self.stores[r]
            lane = (own.inc[r] - own.dec[r])
            rep = self.reps[r]
            if retired[r]:
                continue                     # masked out of every refcount
            held = (rep.frozen_holdings if rep.crashed else rep.holdings())
            expect = np.zeros(self.num_pages, dtype=np.int64)
            for p, c in (held or {}).items():
                expect[p] += c
            if not (lane == expect).all():
                bad = np.nonzero(lane != expect)[0][:8]
                failures.append(
                    f"lane {r} refcount leak at pages {bad.tolist()}: "
                    f"lane={lane[bad].tolist()} held={expect[bad].tolist()}")

        # 5. Free-list / refcount partition per live replica: every home
        #    page is either free (refcount 0) or referenced; a page on the
        #    free list with refcount > 0 would alias live data.
        for r in live:
            rep = self.reps[r]
            refs = self.stores[r].refcounts()
            for p in rep.allocator._free:
                if refs[p] != 0:
                    failures.append(
                        f"replica {r}: free page {p} has refcount {refs[p]}")
            for p in rep.allocator._cooling:
                if refs[p] != 0:
                    failures.append(
                        f"replica {r}: cooling page {p} refcount {refs[p]}")

        # 6. Lease safety (collected online by the monitor).
        if self.monitor.violations:
            failures.append(
                f"{len(self.monitor.violations)} lease violations: "
                f"{self.monitor.violations[:3]}")

        counters: dict[str, int] = {}
        for rep in self.reps:
            for k, v in rep.counters.items():
                counters[k] = counters.get(k, 0) + v
        return {
            "ok": not failures,
            "failures": failures,
            "live_replicas": live,
            "retired": [int(r) for r in np.nonzero(retired)[0]],
            "digest": digests[0][:16] if digests else None,
            "rounds": self.now,
            "channel": {"sent": self.channel.sent,
                        "dropped": self.channel.dropped,
                        "duplicated": self.channel.duplicated},
            "sync_bytes": sum(n.bytes_sent for n in self.nodes),
            "monitor_writes": self.monitor.writes,
            "reclaimed_pages": sum(a.reclaimed_pages for a in self.allocs),
            "fence_steps": sum(a.fence_steps for a in self.allocs),
            "counters": counters,
        }


def run_sim(**kw) -> tuple[dict, dict]:
    """Convenience wrapper: build, run, return (result, trace)."""
    sim = Simulator(**kw)
    result = sim.run()
    return result, sim.trace


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--pages", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--schedule", default="lossy",
                    choices=sorted(SCHEDULES))
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--trace", default=None,
                    help="write JSON convergence trace here")
    args = ap.parse_args(argv)
    result, trace = run_sim(replicas=args.replicas, num_pages=args.pages,
                            seed=args.seed, schedule=args.schedule,
                            steps=args.steps)
    if args.trace:
        with open(args.trace, "w") as f:
            json.dump(trace, f, indent=1, default=str)
    print(json.dumps(result, indent=1, default=str))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
