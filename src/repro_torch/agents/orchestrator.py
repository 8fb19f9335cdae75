"""Multi-agent code-generation orchestrator (the paper's experiment loop).

Agents are rows of one batched decode engine.  Coordination is through CRDT
state only (a TodoBoard and per-agent SlotDoc replicas, merged through the
join): no message passing, no scheduler.  The loop implements the paper's
four observation-driven behaviours:

  completed-work detection   claims skip DONE TODOs (board observation)
  context integration        prompts embed the current content of read slots
  naming alignment           (same mechanism — context replay of neighbours)
  conflict avoidance         optimistic claim → LWW arbitration → losers re-pick

Invalidations: if a read slot's version advances mid-generation, the agent
re-contextualizes (replays a fresh prompt) — the measured source of the
coupled-task slowdown.  Sequential mode is the same machinery with one
agent.

``run_task`` runs on the card unless the caller passes ``device="cpu"``;
the params must live there, and the CRDT state lives there too.  The
host keeps mirrors of positions, last tokens and slot lengths, so a step
costs one model call and one device-to-host read of the sampled tokens.
The model steps are ``lm.mixed_step`` (``--prefill chunked``, the
``paged_chunk_attention[_quant]`` kernels) and ``lm.decode_step`` (the
outliner and the replay baseline: ``paged_decode_attention[_quant]`` or
``decode_attention``).

``replicas > 1`` partitions the agents' page table across that many
metadata replicas (``serving/replicated.ReplicatedPrefixPageMapper``) that
gossip at every coordination sync; ``disaggregate`` homes agent 0 on a
prefill domain whose header pages the others adopt cross-replica.

``spec_decode="ngram"|"doc"`` (with ``prefill="chunked"``) widens
generating agents' spans with host-side drafts (``serving/draft.py``): one
verify step (``lm.verify_step``) scores every row, each agent commits its
accepted prefix plus the bonus token, and rejected tails roll back bitwise
from a pre-verify snapshot (``cache.snapshot_span`` / ``restore_span``).
The ``doc`` drafter reads the live per-slot lists of flushed document
tokens, so what one agent has flushed is draftable for every other.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.agents.tasks import TaskSpec
from repro_torch.core import delta as delta_mod
from repro_torch.core import doc as doc_mod
from repro_torch.core import merge as merge_mod
from repro_torch.core import protocol, todo, tree
from repro_torch.core.clock import Lamport, i32
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.serving import draft as draft_mod
from repro_torch.serving import engine as engine_mod

IDLE, PREFILL, GEN, HALT = "idle", "prefill", "gen", "halt"
OBSERVE_EVERY = 8          # steps between observation sweeps
MAX_REPREFILL = 2          # bounded re-contextualizations per TODO
MAX_MAP_FAILURES = 3       # consecutive page-map failures before giving up
SLOT_CAP = 1024


@dataclass
class AgentState:
    row: int                            # engine batch row
    client: int                         # CRDT client id (>=1)
    phase: str = IDLE
    todo_id: int = -1
    queue: list = field(default_factory=list)     # prompt tokens to replay
    tokens_left: int = 0
    reprefills: int = 0
    lamport: Lamport = None
    failures: int = 0                   # consecutive page-map failures
    needs_map: bool = False             # row unmapped; waiting to retry
    retry_at: int = 0                   # step at which to retry the map
    hist: list = field(default_factory=list)  # raw prompt+generated tokens
                                        # (speculative drafting context)


@dataclass
class RunResult:
    task: str
    mode: str
    n_agents: int
    wall_s: float
    gen_tokens: int
    replay_tokens: int
    steps: int
    invalidations: int
    claim_collisions: int
    observation_events: int
    semantic_conflicts: int
    declared_symbols: int
    converged: bool
    digest: int
    merge_strategy: str = "allgather"
    sync_rounds: int = 0
    sync_bytes: int = 0     # wire bytes (see delta.full_state_wire_bytes)
    kv_mode: str = "dense"          # dense | paged KV cache
    prefill_mode: str = "replay"    # replay (token-by-token) | chunked
    shared_prefix_pages: int = 0    # prompt pages shared across (re-)prefills
    replicas: int = 1               # page-table metadata replicas
    disaggregated: bool = False     # prefill/decode role-partitioned homes
    cross_replica_prefix_hits: int = 0  # prefix pages adopted from a peer
    page_sync_bytes: int = 0        # page-table anti-entropy wire bytes
    agent_failures: int = 0         # page-map failures hit by agent loops
    agent_retries: int = 0          # successful backoff re-maps after failure
    spec_decode: str = "off"        # off | ngram | doc drafting source
    draft_tokens: int = 0           # speculative tokens proposed
    accepted_tokens: int = 0        # draft tokens the verifier accepted
    rollback_tokens: int = 0        # rejected-tail tokens rolled back

    @property
    def accept_rate(self) -> float:
        return self.accepted_tokens / max(1, self.draft_tokens)

    @property
    def tokens_per_s(self) -> float:
        return self.gen_tokens / max(self.wall_s, 1e-9)

    @property
    def s_per_1k_tokens(self) -> float:
        return 1000.0 * self.wall_s / max(self.gen_tokens, 1)

    @property
    def response_steps(self) -> int:
        return self.steps

    @property
    def steps_per_1k_tokens(self) -> float:
        return 1000.0 * self.steps / max(self.gen_tokens, 1)


# ---------------------------------------------------------------------------
# Content model: prompts + semantic-conflict detection
# ---------------------------------------------------------------------------

def _prompt_tokens(task: TaskSpec, todo_id: int, docs, vocab: int,
                   rng: np.random.Generator) -> list[int]:
    """Deterministic task/TODO header + current content of read slots.

    The header seeds from ``hash((task.name, todo_id))``: digests repeat
    across processes only under a fixed ``PYTHONHASHSEED``."""
    base = np.random.default_rng(hash((task.name, todo_id)) % (2**31))
    toks = list(2 + base.integers(0, vocab - 2, size=task.prompt_tokens))
    merged = merge_mod.fold_join(docs)
    lengths = merged.length.cpu().numpy()
    tokens = merged.tokens.cpu().numpy()
    for r in task.reads.get(todo_id, ()):
        n = int(lengths[r])
        if n > 0:     # context integration: read the neighbour's latest code
            tail = tokens[r, max(0, n - task.read_prompt_tokens): n]
            toks.extend(int(t) for t in tail)
    return toks


def count_conflicts(merged: doc_mod.SlotDoc) -> tuple[int, int]:
    """Semantic conflicts: the same symbol *declared* in two different slots.

    Declaration tokens are tokens ≡ 5 (mod 13); the symbol is tok mod 64.
    Returns (conflicts, total_declarations)."""
    lengths = merged.length.cpu().numpy()
    tokens = merged.tokens.cpu().numpy()
    declared: dict[int, int] = {}
    conflicts = 0
    total = 0
    for s in range(merged.num_slots):
        for t in tokens[s, : lengths[s]]:
            t = int(t)
            if t % 13 == 5:
                total += 1
                sym = t % 64
                if sym in declared and declared[sym] != s:
                    conflicts += 1
                else:
                    declared.setdefault(sym, s)
    return conflicts, total


# ---------------------------------------------------------------------------
# The run loop
# ---------------------------------------------------------------------------

def run_task(cfg: ModelConfig, params, task: TaskSpec, *, mode: str,
             n_agents: int = 4, seed: int = 0, max_len: int = 1024,
             merge: str = "allgather", delta_capacity: int = 64,
             kv: str = "dense", prefill: str = "replay",
             page_size: int = 64, chunk_size: int = 32, replicas: int = 1,
             spec_decode: str = "off", spec_k: int = 4,
             kv_quant: str = "off", disaggregate: bool = False,
             time_fn=time.perf_counter, device=None) -> RunResult:
    """One agent trial on ``device`` (the card unless the caller passes
    ``device="cpu"``), where ``params`` must already live.

    ``kv="paged"`` backs the agents with the paged KV cache (optionally
    quantized: ``kv_quant="int8"|"fp8"``).  ``prefill="chunked"`` (alias
    ``"ragged"``) rides the token-budget mixed step: each iteration spends
    one span per agent — a ≤ ``chunk_size`` slice of any pending
    (re-)contextualization prompt AND one decode token for every generating
    agent, in one batched call.  ``"replay"`` is the paper's token-by-token
    baseline (one decode step per prompt token)."""
    assert mode in ("sequential", "parallel")
    assert merge in ("allgather", "pmax", "delta")
    assert kv in ("dense", "paged")
    assert prefill in ("replay", "ragged", "chunked")
    if replicas > 1 and kv != "paged":
        raise ValueError("--replicas > 1 requires the paged KV cache "
                         "(the replicated page table replicates page "
                         "metadata, not a dense per-row cache)")
    if kv_quant != "off" and kv != "paged":
        raise ValueError("--kv-quant requires --kv paged (quantized "
                         "layouts are page-pool layouts)")
    if disaggregate and replicas < 2:
        raise ValueError("--disaggregate requires --replicas >= 2 (one "
                         "prefill home plus at least one decode home)")
    chunked = prefill in ("ragged", "chunked")
    if spec_decode not in ("off", "ngram", "doc"):
        raise ValueError(f"spec_decode must be off/ngram/doc, got "
                         f"{spec_decode!r}")
    if spec_decode != "off" and not chunked:
        raise ValueError("--spec-decode rides the mixed serve step: "
                         "use --prefill chunked (verify widens decode "
                         "spans, which the replay baseline cannot express)")
    if mode == "sequential":
        n_agents = 1
    dev = resolve_device(device)
    if params["embed"]["w"].device != dev:
        raise ValueError(f"params live on {params['embed']['w'].device}, "
                         f"the trial runs on {dev}")
    rng = np.random.default_rng(seed)
    k_todos = task.n_todos
    vocab = cfg.vocab_size

    # Shared coordination state (board) + per-agent document replicas, on
    # the params' device.
    board = todo.empty(k_todos, device=dev)
    out_lam = Lamport.create(client=100, device=dev)
    deps_np = np.zeros((k_todos, k_todos), bool)
    for k, ds in task.deps.items():
        for d in ds:
            deps_np[k, d] = True

    docs = [doc_mod.empty(k_todos, SLOT_CAP, device=dev)
            for _ in range(n_agents)]
    agents = [AgentState(row=i, client=i + 1,
                         lamport=Lamport.create(i + 1, device=dev))
              for i in range(n_agents)]
    state_bytes = delta_mod.nbytes(docs[0])
    delta_sync = (delta_mod.DeltaSync(docs[0], capacity=delta_capacity)
                  if merge == "delta" else None)

    step_fn = engine_mod.make_serve_step(cfg)
    mapper = None
    if kv == "paged":
        from repro_torch.serving.scheduler import PrefixPageMapper
        # Shared-prefix admission: each (re-)contextualization maps the
        # row's pages through a refcounted pool with longest-prefix reuse.
        maxp = -(-max_len // page_size)
        if replicas > 1:
            from repro_torch.serving.replicated import \
                ReplicatedPrefixPageMapper
            # One remap-transient spare slice per metadata replica: agents
            # are partitioned round-robin, so each home partition holds its
            # agents' pages plus one in-flight remap.
            pool_pages = (n_agents + replicas) * maxp
            mapper = ReplicatedPrefixPageMapper(
                n_agents, maxp, page_size, trash_page=pool_pages,
                replicas=replicas, num_pages=pool_pages,
                disaggregate=disaggregate)
        else:
            pool_pages = (n_agents + 1) * maxp     # +maxp: remap transient
            mapper = PrefixPageMapper(n_agents, maxp, page_size,
                                      trash_page=pool_pages)
        cache = lm.init_cache(cfg, n_agents, max_len, paged=True,
                              page_size=page_size,
                              num_pages=pool_pages + 1, kv_quant=kv_quant,
                              device=dev)
        cache = mapper.install(cache)
    else:
        cache = lm.init_cache(cfg, n_agents, max_len, device=dev)

    def recontextualize(a: AgentState) -> bool:
        """Map the agent's new prompt into pages (shared-prefix admission).

        Returns False when the pool cannot serve the re-map right now: the
        agent's row is released and the agent backs off with deterministic
        jitter; only after MAX_MAP_FAILURES consecutive failures does the
        pool-exhausted error propagate."""
        if mapper is None:
            return True
        horizon = min(len(a.queue) + gen_budget, max_len)
        try:
            mapper.map_row(a.row, a.queue, horizon)
        except RuntimeError:
            stats["agent_fail"] += 1
            a.failures += 1
            if a.failures >= MAX_MAP_FAILURES:
                raise
            mapper.free_row(a.row)
            a.needs_map = True
            a.retry_at = stats["steps"] + engine_mod.backoff_steps(
                a.client, a.failures)
            return False
        if a.needs_map:
            stats["agent_retry"] += 1
        a.needs_map = False
        a.failures = 0
        return True

    def push_tables() -> None:
        nonlocal cache
        if mapper is not None:
            cache = mapper.install(cache)

    def to_dev(arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr, np.int32)).to(dev)

    pos = torch.zeros((n_agents,), dtype=torch.int32, device=dev)
    token = torch.ones((n_agents,), dtype=torch.int32, device=dev)
    chunk_size = max(1, min(chunk_size, max_len))
    # Host mirrors for the chunked (mixed-step) path: positions and last
    # tokens never round-trip through the device.
    pos_h = np.zeros((n_agents,), np.int64)
    tok_h = np.ones((n_agents,), np.int64)
    mixed_fn = engine_mod.make_mixed_step_fn(cfg) if chunked else None

    # Speculative decoding through the mixed step: a host-side drafter
    # widens GEN rows from span 1 to 1 + k, one verify call scores the
    # whole batch (rows without a draft read preds at their last span
    # position: greedy sampling), and rejected tails roll back bitwise
    # from a pre-verify snapshot.  The PrefixPageMapper maps each row's
    # whole generation horizon, so speculative writes land in mapped pages
    # and rollback frees no page here.
    drafter = verify_fn = None
    spec_k = max(1, int(spec_k))
    wclamp = chunk_size
    has_state = bool(lm.state_layers(cfg))
    if spec_decode != "off":
        drafter = draft_mod.make_drafter(spec_decode)
        wclamp = max(chunk_size, 1 + spec_k)
        verify_fn = engine_mod.make_verify_step_fn(cfg)

    t0 = time_fn()

    # --- Outliner: generates the skeleton, posts TODOs (both modes pay it).
    for _ in range(6 * k_todos // max(n_agents, 1) + 4):
        token, cache, pos = step_fn(params, cache, token, pos)
    for k in range(k_todos):
        out_lam = out_lam.tick()
        board = todo.post(board, k, torch.as_tensor(deps_np[k], device=dev),
                          out_lam.time, out_lam.client)
    pos = torch.zeros((n_agents,), dtype=torch.int32, device=dev)

    gen_budget = int(round(task.base_tokens
                           * (task.par_inflation if mode == "parallel"
                              else 1.0)))
    stats = dict(gen=0, replay=0, steps=0, inval=0, collide=0, observe=0,
                 syncs=0, sync_bytes=0, agent_fail=0, agent_retry=0,
                 draft=0, accepted=0, rollback=0)
    merge_perm_seed = 0

    # Host-side mirrors: CRDT appends are buffered per agent and flushed at
    # observation boundaries (one run-append per agent per sweep).
    host_len = np.zeros((k_todos,), np.int64)          # merged view lengths
    buffers: list[list[int]] = [[] for _ in range(n_agents)]
    buf_slot = [-1] * n_agents
    # Per-slot mirrors of flushed (committed) document content: the doc
    # drafter reads these LIVE lists, so anything one agent has flushed is
    # draftable for every other agent at once.
    slot_toks: list[list[int]] = [[] for _ in range(k_todos)]
    if drafter is not None and hasattr(drafter, "set_docs"):
        drafter.set_docs(slot_toks)
    done_count = 0
    board_dirty = True
    run_buf_cap = 128

    def flush_agent(i: int):
        nonlocal docs
        if buf_slot[i] < 0 or not buffers[i]:
            return
        toks = buffers[i]
        for off in range(0, len(toks), run_buf_cap):
            chunk = toks[off: off + run_buf_cap]
            arr = np.zeros((run_buf_cap,), np.int32)
            arr[: len(chunk)] = chunk
            docs[i] = doc_mod.append(docs[i], buf_slot[i], to_dev(arr),
                                     len(chunk))
        host_len[buf_slot[i]] += len(toks)
        slot_toks[buf_slot[i]].extend(toks)
        buffers[i] = []

    def sync_replicas():
        nonlocal docs, merge_perm_seed
        for i in range(n_agents):
            flush_agent(i)
        stats["syncs"] += 1
        if replicas > 1 and mapper is not None:
            mapper.gossip()               # page-table anti-entropy round
        if delta_sync is not None:
            docs = delta_sync.sync(docs)
            stats["sync_bytes"] = delta_sync.bytes_shipped
            return
        perm = np.random.default_rng(merge_perm_seed).permutation(n_agents)
        merge_perm_seed += 1
        m = merge_mod.fold_join([docs[i] for i in perm])
        docs = [m for _ in range(n_agents)]
        stats["sync_bytes"] += delta_mod.full_state_wire_bytes(
            merge, n_agents, state_bytes)

    snap_len = {a.client: host_len.copy() for a in agents}

    def finish_agent(a: AgentState):
        nonlocal board, done_count, board_dirty
        flush_agent(a.row)
        a.lamport = a.lamport.observe(board.max_clock())
        board = todo.complete(board, a.todo_id, a.client, a.lamport.time)
        done_count += 1
        board_dirty = True
        a.phase = IDLE
        buf_slot[a.row] = -1
        a.todo_id = -1
        sync_replicas()

    while True:
        # -- claims: all idle agents observe the SAME board snapshot --------
        idle = [a for a in agents if a.phase == IDLE]
        if idle and board_dirty:
            clients = torch.tensor([a.client for a in idle],
                                   dtype=torch.int32, device=dev)
            clocks_h = [int(a.lamport.observe(board.max_clock()).time)
                        for a in idle]
            clocks = torch.tensor(clocks_h, dtype=torch.int32, device=dev)
            board, ks, won = protocol.concurrent_claims(
                board, clients, clocks, stats["steps"])
            any_won = False
            for a, k, w, c in zip(idle, ks.tolist(), won.tolist(), clocks_h):
                a.lamport = a.lamport._replace(time=i32(c, dev))
                if w:
                    any_won = True
                    a.todo_id = int(k)
                    a.phase = PREFILL
                    a.reprefills = 0
                    a.queue = _prompt_tokens(task, a.todo_id, docs, vocab,
                                             rng)
                    a.hist = list(a.queue)
                    a.tokens_left = gen_budget
                    snap_len[a.client] = host_len.copy()
                    buf_slot[a.row] = a.todo_id
                    pos_h[a.row] = 0
                    if mixed_fn is None:
                        pos[a.row] = 0
                    recontextualize(a)
                else:
                    stats["collide"] += 1
            if not any_won:
                board_dirty = False      # wait for a completion to retry

        if all(a.phase == HALT for a in agents):
            break
        if done_count >= k_todos and all(
                a.phase in (IDLE, HALT) for a in agents):
            break
        if not any(a.phase in (PREFILL, GEN) for a in agents):
            # Deadlock guard: nothing runnable and nothing claimable yet.
            if done_count >= k_todos:
                break
            board_dirty = True
            stats["steps"] += 1
            if stats["steps"] > 20_000:
                break
            continue

        if mixed_fn is not None:
            # -- one token-budget mixed step: every pending prompt spends a
            # ≤ chunk_size slice AND every generating agent decodes one
            # token, in the same batched call.
            spans = np.zeros((n_agents,), np.int64)
            finishing: list[AgentState] = []
            for a in agents:
                if a.phase == PREFILL and a.needs_map:
                    # Unmapped row: idle this lane (span 0) until the
                    # backoff expires and a re-map succeeds.
                    if not (stats["steps"] >= a.retry_at
                            and recontextualize(a)):
                        continue
                if a.phase == PREFILL and a.queue:
                    spans[a.row] = min(chunk_size, len(a.queue))
                elif a.phase == PREFILL:
                    a.phase = GEN
                    spans[a.row] = 1
                elif a.phase == GEN:
                    spans[a.row] = 1
            drafts: dict[int, list[int]] = {}
            if drafter is not None:
                # Widen decode rows with drafter proposals.  The cap keeps
                # every speculative write inside the row's mapped horizon
                # and the accepted run inside the agent's remaining budget.
                for a in agents:
                    if a.phase != GEN or spans[a.row] != 1:
                        continue
                    cap = min(spec_k, a.tokens_left - 1,
                              max_len - int(pos_h[a.row]) - 1)
                    if cap <= 0:
                        continue
                    d = drafter.propose(a.hist, cap)[:cap]
                    if d:
                        drafts[a.row] = d
                        spans[a.row] = 1 + len(d)
            width = engine_mod.width_bucket(int(max(spans.max(), 1)),
                                            wclamp)
            toks = np.zeros((n_agents, width), np.int64)
            for a in agents:
                if spans[a.row] == 0:
                    continue
                if a.phase == PREFILL:
                    seg = a.queue[: int(spans[a.row])]
                    a.queue = a.queue[int(spans[a.row]):]
                    toks[a.row, :len(seg)] = seg
                    stats["replay"] += len(seg)
                else:
                    toks[a.row, 0] = tok_h[a.row]
                    d = drafts.get(a.row)
                    if d:
                        toks[a.row, 1:1 + len(d)] = d
            push_tables()
            start_d = to_dev(pos_h)                # pre-step positions
            if verify_fn is not None:
                snap = (lm.rollback_snapshot(cfg, cache, start_d, width)
                        if drafts else None)
                preds_d, acc_d, cache = verify_fn(params, cache,
                                                  to_dev(toks), start_d,
                                                  to_dev(spans))
                # preds and accept counts in one copy: the step's one sync.
                both = torch.cat([preds_d, acc_d[:, None]], 1).cpu().numpy()
                preds, acc = both[:, :-1], both[:, -1]
                sampled = preds[np.arange(n_agents),
                                np.clip(spans - 1, 0, width - 1)]
            else:
                nxt, cache = mixed_fn(params, cache, to_dev(toks), start_d,
                                      to_dev(spans))
                sampled = nxt.cpu().numpy()    # the one per-step sync
            stats["steps"] += 1
            roll_lo = np.zeros((n_agents,), np.int64)
            roll_hi = np.zeros((n_agents,), np.int64)
            replay_spans = np.zeros((n_agents,), np.int64)
            for a in agents:
                if spans[a.row] == 0:
                    continue
                d = drafts.get(a.row)
                if d is not None:
                    # Speculative row: commit the longest accepted prefix
                    # plus the verifier's bonus token; mark the rejected
                    # tail for rollback.
                    pos0 = int(pos_h[a.row])
                    appended, a_dev = draft_mod.accept_tokens(
                        d, acc[a.row], preds[a.row], a.tokens_left, None)
                    n_app = len(appended)
                    stats["draft"] += len(d)
                    stats["accepted"] += min(n_app, a_dev)
                    n_roll = int(spans[a.row]) - n_app
                    pos_h[a.row] += n_app
                    for t in appended:
                        buffers[a.row].append(int(t) % vocab)
                        a.hist.append(int(t))
                    tok_h[a.row] = int(appended[-1])
                    stats["gen"] += n_app
                    a.tokens_left -= n_app
                    if n_roll > 0:
                        stats["rollback"] += n_roll
                        roll_lo[a.row] = pos0 + n_app
                        roll_hi[a.row] = pos0 + int(spans[a.row])
                        replay_spans[a.row] = n_app
                    if a.tokens_left <= 0:
                        finishing.append(a)
                    continue
                pos_h[a.row] += int(spans[a.row])
                if a.phase == PREFILL:
                    if a.queue:
                        continue            # mid-prompt logits: discarded
                    a.phase = GEN           # chunk's last logits = 1st token
                tok_h[a.row] = int(sampled[a.row])
                buffers[a.row].append(int(sampled[a.row]) % vocab)
                if drafter is not None:
                    a.hist.append(int(sampled[a.row]))
                stats["gen"] += 1
                a.tokens_left -= 1
                if a.tokens_left <= 0:
                    finishing.append(a)
            if replay_spans.any():
                # Rejected tails back to their pre-verify bytes; recurrent
                # carries back to their pre-verify value, then advanced by
                # replaying exactly the committed tokens (their attention
                # writes rewrite the same tokens at the same positions).
                cache = lm.rollback_restore(cfg, cache, snap, start_d,
                                            to_dev(roll_lo), to_dev(roll_hi),
                                            torch.from_numpy(replay_spans > 0))
                if has_state:
                    w2 = engine_mod.width_bucket(int(replay_spans.max()),
                                                 wclamp)
                    _, _, cache = verify_fn(params, cache,
                                            to_dev(toks[:, :w2]), start_d,
                                            to_dev(replay_spans))
            for a in finishing:
                finish_agent(a)
        else:
            # -- one batched decode step (replay baseline) -------------------
            forced = token.cpu().numpy().copy()
            for a in agents:
                if a.phase == PREFILL and a.needs_map:
                    # Unmapped row: its writes land on the trash page, but
                    # its prompt must not be consumed.  On a successful
                    # re-map, restart from 0.
                    if stats["steps"] >= a.retry_at and recontextualize(a):
                        pos[a.row] = 0
                    else:
                        continue
                if a.phase == PREFILL and a.queue:
                    forced[a.row] = a.queue.pop(0)
                    stats["replay"] += 1
                elif a.phase == PREFILL:
                    a.phase = GEN
            token = to_dev(forced)
            push_tables()
            token, cache, pos = step_fn(params, cache, token, pos)
            stats["steps"] += 1
            sampled = token.cpu().numpy()      # the one per-step sync

            # -- generation & completion ------------------------------------
            for a in agents:
                if a.phase != GEN:
                    continue
                buffers[a.row].append(int(sampled[a.row]) % vocab)
                stats["gen"] += 1
                a.tokens_left -= 1
                if a.tokens_left <= 0:
                    finish_agent(a)

        # -- observation sweep (paper §4.2) ----------------------------------
        if stats["steps"] % OBSERVE_EVERY == 0:
            sync_replicas()
            for a in agents:
                if a.phase not in (GEN, PREFILL):
                    continue
                delta = host_len - snap_len[a.client]
                stats["observe"] += int(delta.clip(0).sum())
                reads = task.reads.get(a.todo_id, ())
                if any(delta[r] > 0 for r in reads):
                    if a.reprefills < MAX_REPREFILL:
                        a.reprefills += 1
                        stats["inval"] += 1
                        a.queue = _prompt_tokens(task, a.todo_id, docs,
                                                 vocab, rng)
                        a.hist = list(a.queue)
                        a.phase = PREFILL
                        pos_h[a.row] = 0
                        if mixed_fn is None:
                            pos[a.row] = 0
                        recontextualize(a)
                    snap_len[a.client] = host_len.copy()

        if stats["steps"] > 20_000:   # safety valve
            for a in agents:
                a.phase = HALT
            break

    sync_replicas()
    if delta_sync is not None:
        # Drain capacity-overflow backlog: sync until the frontier reaches
        # its fixed point, so replicas are converged before scoring.
        for _ in range(10_000):
            before = [x.cpu() for x in tree.leaves(delta_sync.frontier)]
            sync_replicas()
            after = [x.cpu() for x in tree.leaves(delta_sync.frontier)]
            if all(torch.equal(b, a) for b, a in zip(before, after)):
                break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time_fn() - t0

    final = merge_mod.fold_join(docs)
    digests = [int(doc_mod.digest(d)) for d in docs]
    conflicts, total_decl = count_conflicts(final)
    return RunResult(
        task=task.name, mode=mode, n_agents=n_agents, wall_s=wall,
        gen_tokens=stats["gen"], replay_tokens=stats["replay"],
        steps=stats["steps"], invalidations=stats["inval"],
        claim_collisions=stats["collide"],
        observation_events=stats["observe"],
        semantic_conflicts=conflicts, declared_symbols=total_decl,
        converged=all(d == digests[0] for d in digests),
        digest=digests[0],
        merge_strategy=merge, sync_rounds=stats["syncs"],
        sync_bytes=int(stats["sync_bytes"]),
        kv_mode=kv, prefill_mode=prefill,
        shared_prefix_pages=mapper.shared_pages if mapper else 0,
        replicas=replicas, disaggregated=disaggregate,
        cross_replica_prefix_hits=getattr(mapper, "cross_replica_hits", 0),
        page_sync_bytes=getattr(mapper, "sync_bytes", 0),
        agent_failures=stats["agent_fail"],
        agent_retries=stats["agent_retry"],
        spec_decode=spec_decode,
        draft_tokens=stats["draft"],
        accepted_tokens=stats["accepted"],
        rollback_tokens=stats["rollback"])


def make_sim_llm(seed: int = 0, device=None):
    """Tiny but real decoder used as the agents' LLM (reduced olmo-1b:
    d_model 64, vocab 512, 2 layers), random bf16 weights from the port's
    own seeded generator on ``device`` (the card unless ``"cpu"``)."""
    from repro_torch import configs
    cfg = configs.reduced(configs.get("olmo-1b"), d_model=64,
                          vocab=512).replace(num_layers=2)
    return cfg, lm.init(cfg, seed=seed, device=device)


def main() -> None:
    """Run one task end to end with a chosen replica-merge strategy.

    PYTHONHASHSEED=0 PYTHONPATH=src python -m repro_torch.agents.orchestrator \\
        --task dashboard --mode parallel --agents 4 --merge delta \\
        --kv paged --prefill chunked --page-size 16 --kv-quant int8
    (``--device cpu`` runs the plain PyTorch path without a card.)
    """
    import argparse
    from repro_torch.agents.tasks import TASKS

    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default=next(iter(TASKS)), choices=list(TASKS))
    ap.add_argument("--mode", default="parallel",
                    choices=["sequential", "parallel"])
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--merge", default="allgather",
                    choices=["allgather", "pmax", "delta"])
    ap.add_argument("--delta-capacity", type=int, default=64)
    ap.add_argument("--kv", default="dense", choices=["dense", "paged"],
                    help="KV cache layout for the agents' decode engine")
    ap.add_argument("--prefill", default="replay",
                    choices=["replay", "ragged", "chunked"],
                    help="prompt (re-)contextualization: token-by-token "
                         "replay, or chunked admission through the "
                         "token-budget mixed step ('ragged' is an alias "
                         "for 'chunked')")
    ap.add_argument("--page-size", type=int, default=64)
    ap.add_argument("--chunk-size", type=int, default=32)
    ap.add_argument("--replicas", type=int, default=1,
                    help="page-table metadata replicas (> 1 requires "
                         "--kv paged): agents are partitioned across "
                         "replicas that gossip the CRDT page table")
    ap.add_argument("--spec-decode", default="off",
                    choices=["off", "ngram", "doc"],
                    help="speculative decoding through the mixed step: "
                         "'ngram' drafts from each agent's own "
                         "prompt+generated history (prompt lookup), 'doc' "
                         "drafts from the shared CRDT document content "
                         "with n-gram fallback (requires --prefill chunked)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="max draft tokens proposed per agent per step")
    ap.add_argument("--kv-quant", default="off",
                    choices=["off", "int8", "fp8"],
                    help="quantized page pools (requires --kv paged): int8 "
                         "or fp8 values plus per-row f32 scales")
    ap.add_argument("--disaggregate", action="store_true",
                    help="prefill/decode role-partitioned page homes "
                         "(requires --replicas >= 2): agent 0 publishes "
                         "the shared prompt header, the others adopt it "
                         "cross-replica")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg, params = make_sim_llm(args.seed, device=args.device)
    r = run_task(cfg, params, TASKS[args.task], mode=args.mode,
                 n_agents=args.agents, seed=args.seed, merge=args.merge,
                 delta_capacity=args.delta_capacity, kv=args.kv,
                 prefill=args.prefill, page_size=args.page_size,
                 chunk_size=args.chunk_size, replicas=args.replicas,
                 spec_decode=args.spec_decode, spec_k=args.spec_k,
                 kv_quant=args.kv_quant, disaggregate=args.disaggregate,
                 device=args.device)
    for k, v in sorted(vars(r).items()):
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
