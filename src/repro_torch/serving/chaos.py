"""Chaos harness: seeded faults against the REAL multi-engine server.

The simulator shows the replicated page table converges under adversarial
gossip — but over abstract replicas.  This harness drives the
actual ``MultiEngineServer`` (real ``ContinuousBatchingEngine``s decoding a
real model) through the simulator's ``FaultyChannel`` schedules, crashes an
engine mid-flight, and asserts the end-to-end invariants the serving tier
promises:

  1. **Exactly-once completion** — every accepted request that was never
     shed/expired/failed has exactly one ``J_DONE`` in the merged journal
     (and no request ever has more than one).
  2. **Bitwise convergence** — after quiescence (channel healed, frozen
     heartbeats, gossip drained) every live replica's page-table digest is
     identical.
  3. **Per-lane refcount conservation** — at every step, each live
     replica's own counter lane holds exactly one reference per page bound
     to one of its rows; and the merged view never shows ``dec > inc``
     anywhere (no double-free), including across failover.

Run it as a module (the tiny model runs on the card unless ``--device
cpu``)::

    PYTHONPATH=src python -m repro_torch.serving.chaos --schedule lossy \
        --seed 0 --crash-at 6 --out chaos_trace.json

The JSON trace (events, per-invariant verdicts, channel + server stats) is
written win or lose.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Optional

import numpy as np

from repro_torch.serving import replicated as repl
from repro_torch.serving.scheduler import Request
from repro_torch.serving.simulator import SCHEDULES, FaultyChannel


def tiny_model(device=None):
    """The tests' tiny LLM (olmo-1b reduced: d_model 32, vocab 128, 2
    layers) with float32 weights from the port's own seeded init, on
    ``device`` (the card unless ``"cpu"``): small, but real enough that
    recovered requests re-decode through the model."""
    import torch

    from repro_torch import configs
    from repro_torch.models import lm
    cfg = configs.reduced(configs.get("olmo-1b"), d_model=32, vocab=128)
    cfg = cfg.replace(num_layers=2)
    params = lm.init(cfg, seed=0, device=device)

    def f32(t):
        if isinstance(t, dict):
            return {k: f32(v) for k, v in t.items()}
        if isinstance(t, list):
            return [f32(v) for v in t]
        return t.float()
    return cfg, f32(params)


def fanout_requests(rng: np.random.Generator, count: int = 10,
                    prompt_len: int = 12, new_tokens: int = 4
                    ) -> list[Request]:
    """Two prompt families interleaved AABB… (round-robin dispatch lands
    copies on several replicas; shared prefixes exercise the replicated
    prefix map during recovery re-admission)."""
    prompts = {c: [int(t) for t in rng.integers(2, 100, prompt_len)]
               for c in "AB"}
    pattern = ("AABB" * (count // 4 + 1))[:count]
    return [Request(rid=i, prompt=list(prompts[c]),
                    max_new_tokens=new_tokens)
            for i, c in enumerate(pattern)]


def _lane_conservation(server: repl.MultiEngineServer, r: int) -> bool:
    """Replica r's own counter lane == references held by its bound rows."""
    store = server.stores[r]
    held = np.zeros(store.num_pages, np.int64)
    for req in server.engines[r].rows:
        if req is not None:
            for p in req.pages:
                held[p] += 1
    lane = store.inc[r].astype(np.int64) - store.dec[r].astype(np.int64)
    return bool(np.array_equal(lane, held))


def _exactly_once(server: repl.MultiEngineServer) -> tuple[bool, dict]:
    """Fold a live replica's merged journal and check delivery semantics."""
    live = [r for r in range(server.replicas) if not server.crashed[r]]
    store = server.stores[live[0]]
    accepted: set[int] = set()
    dropped: set[int] = set()          # shed / expired / failed
    dones: dict[int, int] = {}
    for _lane, rid, tag, _a, _b in store.journal_entries():
        if tag == repl.J_ACCEPT:
            accepted.add(rid)
        elif tag in (repl.J_SHED, repl.J_EXPIRED, repl.J_FAIL):
            dropped.add(rid)
        elif tag == repl.J_DONE:
            dones[rid] = dones.get(rid, 0) + 1
    must_complete = accepted - dropped
    ok = (all(dones.get(rid, 0) == 1 for rid in must_complete)
          and all(n <= 1 for n in dones.values()))
    detail = {"accepted": sorted(accepted), "dropped": sorted(dropped),
              "done_counts": {str(k): v for k, v in sorted(dones.items())},
              "missing": sorted(must_complete - set(dones)),
              "duplicated": sorted(k for k, v in dones.items() if v > 1)}
    return ok, detail


def _no_double_free(server: repl.MultiEngineServer) -> bool:
    """Merged view: no lane anywhere released more than it acquired."""
    return all(bool(np.all(server.stores[r].dec <= server.stores[r].inc))
               for r in range(server.replicas) if not server.crashed[r])


def _xfer_balanced(server: repl.MultiEngineServer) -> tuple[bool, dict]:
    """Transfer journal balance: after quiescence every ``J_XFER_BEGIN``
    is closed by exactly one ``J_XFER_COMMIT`` or ``J_XFER_ABORT`` in the
    same lane for the same (rid, page, seq).  Transfers are journaled in
    the ADOPTER's lane, so an exporter crash cannot lose the closer — an
    unbalanced journal means a transfer left the adopter in limbo."""
    live = [r for r in range(server.replicas) if not server.crashed[r]]
    store = server.stores[live[0]]
    opens: dict[tuple, int] = {}
    begins = commits = aborts = 0
    for lane, rid, tag, a, b in store.journal_entries():
        key = (lane, rid, a, b)
        if tag == repl.J_XFER_BEGIN:
            opens[key] = opens.get(key, 0) + 1
            begins += 1
        elif tag == repl.J_XFER_COMMIT:
            opens[key] = opens.get(key, 0) - 1
            commits += 1
        elif tag == repl.J_XFER_ABORT:
            opens[key] = opens.get(key, 0) - 1
            aborts += 1
    ok = all(v == 0 for v in opens.values())
    detail = {"begins": begins, "commits": commits, "aborts": aborts,
              "unbalanced": [list(k) for k, v in opens.items() if v != 0]}
    return ok, detail


def drain(server: repl.MultiEngineServer, max_rounds: int = 300) -> bool:
    """Quiesce (mirrors the simulator's two-phase scheme): heartbeats
    frozen — no engine steps, no ``maintain`` — gossip rounds until every
    live digest matches, then pump-only ticks to flush the last in-flight
    packets (late deltas join as no-ops on converged state; acks only
    advance frontiers)."""
    server.channel.healed = True
    for _ in range(max_rounds):
        server.clock += 1
        server.sync()
        if server.converged():
            break
    else:
        return False
    for _ in range(max_rounds):
        if server.channel.in_flight == 0:
            break
        server.clock += 1
        server._pump(server.clock)
    return bool(server.channel.in_flight == 0 and server.converged())


def run_chaos(cfg=None, params=None, *, schedule: str = "lossy",
              seed: int = 0, replicas: int = 3, batch: int = 3,
              max_len: int = 32, page_size: int = 8, chunk_size: int = 8,
              sync_every: int = 1, ttl: Optional[int] = None,
              crash_replica: Optional[int] = 1, crash_at: int = 4,
              count: int = 10, prompt_len: int = 12, new_tokens: int = 6,
              max_queue: Optional[int] = None, max_steps: int = 3000,
              disagg: bool = False, xfer_crash: bool = False,
              device=None) -> dict[str, Any]:
    """One seeded chaos trial.  Returns the JSON-able fault trace; the
    headline verdict is ``trace["ok"]``.

    ``disagg=True`` runs a disaggregated topology (replica 0 prefill, the
    rest decode) and staggers submissions so later requests arrive after
    the prefill replica has published filled pages — routing sends them to
    decode replicas, whose adoption hooks physically transfer the bytes.
    ``xfer_crash=True`` additionally crash-stops the prefill replica in
    the middle of its first exported transfer (``arm_transfer_crash``), so
    the trial asserts the adopter rolled back cleanly (the rule-3 epoch
    re-check aborted) on top of the usual invariants.
    """
    if cfg is None:
        cfg, params = tiny_model(device)
    device = params["embed"]["w"].device
    spec = SCHEDULES[schedule]
    channel = FaultyChannel(np.random.default_rng(seed + 1), spec)
    roles = (["prefill"] + ["decode"] * (replicas - 1)) if disagg else None
    server = repl.MultiEngineServer(
        cfg, params, replicas=replicas, batch=batch, max_len=max_len,
        page_size=page_size, sync_every=sync_every, ttl=ttl,
        chunk_size=chunk_size, channel=channel, max_queue=max_queue,
        roles=roles, device=device)
    if xfer_crash:
        server.arm_transfer_crash(0)       # exporter dies mid-transfer
        crash_replica = None               # the transfer IS the crash event
    rng = np.random.default_rng(seed)
    requests = fanout_requests(rng, count, prompt_len, new_tokens)
    events: list[dict] = []
    pending = list(requests)
    # Disaggregated mode staggers arrivals (one per step after the first
    # batch) so the decode tier sees published pages; otherwise everything
    # arrives at t=0 as before.
    first_wave = batch if disagg else len(pending)
    for req in pending[:first_wave]:
        events.append({"t": 0, "event": "submit", "rid": req.rid,
                       "replica": server.submit(req)})
    pending = pending[first_wave:]
    conservation_ok = True
    steps = 0
    while steps < max_steps:
        if (crash_replica is not None and not server.crashed[crash_replica]
                and server.clock >= crash_at):
            server.crash(crash_replica)
            events.append({"t": server.clock, "event": "crash",
                           "replica": crash_replica})
        if pending and steps >= 1:
            req = pending.pop(0)
            events.append({"t": server.clock, "event": "submit",
                           "rid": req.rid, "replica": server.submit(req)})
        more = server.step()
        steps += 1
        if pending:
            more = True                    # arrivals still queued here
        for r in range(server.replicas):
            if not server.crashed[r] and not _lane_conservation(server, r):
                conservation_ok = False
                events.append({"t": server.clock, "event":
                               "conservation_violation", "replica": r})
        if not more:
            break
    drained = drain(server)
    once_ok, once_detail = _exactly_once(server)
    no_dfree = _no_double_free(server)
    converged = bool(server.converged() and channel.in_flight == 0)
    xfer_ok, xfer_detail = _xfer_balanced(server)
    invariants = {"exactly_once": once_ok, "converged": converged,
                  "drained": drained,
                  "lane_conservation": conservation_ok,
                  "no_double_free": no_dfree,
                  "xfer_journal_balanced": xfer_ok}
    if xfer_crash:
        # The armed crash must actually have fired mid-transfer, and the
        # adopter must have aborted (rolled its provisional share back).
        invariants["xfer_crash_fired"] = bool(server._xfer_crash is None)
        invariants["adopter_rolled_back"] = bool(server.adopt_aborts >= 1)
    elif disagg:
        # No-crash disagg run: the decode tier must actually have adopted.
        invariants["pages_adopted"] = bool(server.transferred_pages > 0)
    trace = {
        "schedule": schedule, "seed": seed, "replicas": replicas,
        "crash_replica": crash_replica, "crash_at": crash_at,
        "disagg": disagg, "xfer_crash": xfer_crash,
        "steps": steps, "hit_max_steps": steps >= max_steps,
        "events": events,
        "channel": {"sent": channel.sent, "dropped": channel.dropped,
                    "duplicated": channel.duplicated,
                    "in_flight": channel.in_flight},
        "server": server.stats(),
        "invariants": invariants,
        "exactly_once_detail": once_detail,
        "xfer_detail": xfer_detail,
    }
    trace["ok"] = bool(all(invariants.values())
                       and not trace["hit_max_steps"])
    return trace


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--schedule", default="lossy",
                    choices=sorted(SCHEDULES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--crash-at", type=int, default=4)
    ap.add_argument("--crash-replica", type=int, default=1)
    ap.add_argument("--no-crash", action="store_true")
    ap.add_argument("--count", type=int, default=10)
    ap.add_argument("--ttl", type=int, default=None)
    ap.add_argument("--disagg", action="store_true",
                    help="prefill/decode roles + staggered arrivals")
    ap.add_argument("--xfer-crash", action="store_true",
                    help="crash the prefill exporter mid-transfer "
                         "(implies --disagg)")
    ap.add_argument("--out", default=None, help="fault-trace JSON path")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    trace = run_chaos(schedule=args.schedule, seed=args.seed,
                      replicas=args.replicas, ttl=args.ttl,
                      crash_replica=None if args.no_crash
                      else args.crash_replica,
                      crash_at=args.crash_at, count=args.count,
                      disagg=args.disagg or args.xfer_crash,
                      xfer_crash=args.xfer_crash, device=args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(trace, f, indent=2, default=int)
    verdicts = " ".join(f"{k}={'PASS' if v else 'FAIL'}"
                        for k, v in trace["invariants"].items())
    print(f"chaos[{args.schedule} seed={args.seed}] {verdicts} "
          f"recovered={trace['server']['recovered_requests']} "
          f"shed={trace['server']['shed']} "
          f"retried={trace['server']['retried']} "
          f"xfer={trace['xfer_detail']['begins']}b/"
          f"{trace['xfer_detail']['commits']}c/"
          f"{trace['xfer_detail']['aborts']}a")
    return 0 if trace["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
