"""Continuous batching over the paged KV cache: token-budget mixed steps,
chunk-granular page accounting, growth at page boundaries and preemption by
recompute (the plain-paged-serving part of ``repro.serving.scheduler``).

The scheduler owns a fixed decode batch of B rows backed by a shared page
pool.  Every iteration is ONE token-budget mixed step: decode rows get span
1, rows whose prompt is being admitted get a chunk of at most
``chunk_size`` tokens through a per-request prompt cursor, idle rows span 0
— all in one ``lm.mixed_step`` call, whose attention is the
``paged_chunk_attention`` kernel on the card.  ``token_budget`` caps the new
tokens a step may spend (decode rows are funded first).

Admission reserves only the pages the first chunk needs; later chunks and
generated tokens allocate pages as the cursor crosses page boundaries.  A
finished row's pages return to the pool at once.  When growth finds the
pool empty, the least-recently-allocating other row is preempted: its pages
are released and it is re-queued at the front with its generated tokens
folded into its context (preemption by recompute).

Unallocated table slots point at one extra *trash* page: idle rows ride the
batched step with span 0 and write nothing, but a row's writes can never
reach a live page through an unmapped slot.  Several rows may write the
trash page in one step; its contents are unspecified.

Prefix sharing (``prefix_sharing=True``): rows admitted with an identical
prompt share the prompt's pages (refcounted, copy-on-write).  A row's
writes below its shared-prefix match (``safe_upto``) land identical bytes
and need no copy; the first divergent write into a still-shared page
duplicates it copy-then-remap (``cache.copy_pages``).

The runtime around the step: TTFT and end-to-end deadlines expire queued
and running requests, a bounded queue (``max_queue``) sheds by priority, a
halted replica sheds its queue, a request in retry backoff (``retry_at``)
is skipped without blocking the ones behind it, and a ``journal`` hook
records progress and terminal states.  The allocator and prefix cache are
injectable (the replicated ones of ``serving/replicated.py``), and
``role`` / ``adopt_hook`` let a decode replica adopt a peer's physical
pages at admission (disaggregation).

Dense mode (``paged=False``) runs the same composer against the
[B, Hkv, S, D] cache; ``kv_quant="int8"|"fp8"`` stores the pools quantized
with f32 row scales (``paged_chunk_attention_quant`` on the card).  A model
with recurrent (``state``) layers resets an admitted row's carry to fresh
init, so a freed row's state never leaks into the next request; its
windowed and recurrent layers hold no pool, and with ``paged=True`` the
pages are accounted for all the same, as in the JAX package.
Speculative decoding and the swap tier are not ported yet: their options
raise NotImplementedError naming the ROADMAP.md item.

``PageAllocator`` (refcounted), ``PrefixCache`` and ``PrefixPageMapper``
also serve the agent trial (``agents/orchestrator.run_task``): each agent's
(re-)contextualization maps its row's pages with longest-prefix reuse.
"""
from __future__ import annotations

import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.serving import engine as engine_mod

Params = Any

# Request lifecycle states.  QUEUED -> RUNNING -> COMPLETED is the happy
# path; PREEMPTED requests re-queue at the front and run again; SHED /
# EXPIRED / FAILED are terminal (a failed-over request is reconstructed as
# a fresh QUEUED request by the survivor, see serving/replicated.py).
QUEUED = "queued"
RUNNING = "running"
PREEMPTED = "preempted"
FAILED = "failed"
SHED = "shed"
EXPIRED = "expired"
COMPLETED = "completed"


def _later(option: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{option} is not ported yet: ROADMAP.md queue 1 {item}")


class Reservation:
    """Pages earmarked for one admission candidate (already out of the free
    list, so a later candidate's ``available`` check cannot double-count
    them).  ``take`` hands them out; ``release`` returns the rest."""

    def __init__(self, allocator: "PageAllocator", pages: list[int]):
        self._allocator = allocator
        self._pages = pages

    def take(self, n: int | None = None) -> list[int]:
        n = len(self._pages) if n is None else n
        out, self._pages = self._pages[:n], self._pages[n:]
        return out

    def release(self) -> None:
        if self._pages:
            self._allocator.free(self._pages)
            self._pages = []


def _row_ctx(row: Optional[int]) -> str:
    """Error-message suffix naming the engine row an allocator misuse came
    from (allocators are row-agnostic; callers pass the context)."""
    return "" if row is None else f" (row {row})"


class PageAllocator:
    """Host-side refcounted page pool (unit = one page).

    Pages are handed out at refcount 1; ``share`` adds a reference (prefix
    sharing), ``free`` drops one and returns the page to the free list at
    zero (a free of an unreferenced page raises).  ``generation`` bumps on
    every fresh hand-out so stale prefix entries can detect reuse.
    ``reserve`` removes pages from the free list immediately, so a
    two-phase admit cannot admit two requests against the same
    availability snapshot.
    """

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, -1, -1))
        self._ref = np.zeros(num_pages, np.int32)
        self._gen = np.zeros(num_pages, np.int64)

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[list[int]]:
        if n <= 0:
            return []                 # [:-0] would hand out the whole list
        if n > len(self._free):
            return None
        pages, self._free = self._free[-n:][::-1], self._free[:-n]
        for p in pages:
            self._ref[p] = 1
            self._gen[p] += 1
        return pages

    def reserve(self, n: int) -> Optional[Reservation]:
        pages = self.alloc(n)
        if pages is None:
            return None
        return Reservation(self, pages)

    def share(self, pages: list[int], row: Optional[int] = None) -> None:
        for p in pages:
            if self._ref[p] <= 0:
                raise ValueError(
                    f"cannot share unallocated page {p}{_row_ctx(row)} "
                    f"(refcount {int(self._ref[p])})")
            self._ref[p] += 1

    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    def generation(self, page: int) -> int:
        return int(self._gen[page])

    def free(self, pages: list[int], row: Optional[int] = None) -> None:
        for p in reversed(pages):
            if self._ref[p] <= 0:
                raise ValueError(
                    f"double free of page {p}{_row_ctx(row)} "
                    f"(refcount {int(self._ref[p])})")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)


class PrefixCache:
    """Longest-prefix index from prompt tokens to resident pages.

    Full pages chain through keys ``tuple(tokens[:k*ps])`` (page k-1 holds
    positions [(k-1)·ps, k·ps) and its KV depends on the whole prefix, so
    the key must be the whole prefix); the partial boundary page is indexed
    by the exact full prompt.  Entries carry (page, generation) and are
    pruned lazily when the page was freed or re-allocated.  Both maps are
    LRU-bounded at ``max_entries`` (stale keys of distinct prompts would
    otherwise grow the index without bound): hits refresh recency, inserts
    past the cap evict the coldest key.  Eviction only forgets a sharing
    opportunity.
    """

    def __init__(self, allocator: PageAllocator, page_size: int,
                 max_entries: int = 4096):
        self._allocator = allocator
        self.page_size = page_size
        self.max_entries = max_entries
        self._chain: OrderedDict[tuple, tuple[int, int]] = OrderedDict()
        self._boundary: OrderedDict[tuple, tuple[int, int]] = OrderedDict()

    def _get(self, table: "OrderedDict[tuple, tuple[int, int]]", key: tuple
             ) -> Optional[int]:
        """Validated lookup: refreshes recency on hit, prunes on miss."""
        entry = table.get(key)
        if entry is not None:
            page, gen = entry
            if (self._allocator.refcount(page) > 0
                    and self._allocator.generation(page) == gen):
                table.move_to_end(key)
                return page
        table.pop(key, None)
        return None

    def _put(self, table: "OrderedDict[tuple, tuple[int, int]]", key: tuple,
             page: int) -> None:
        table[key] = (page, self._allocator.generation(page))
        table.move_to_end(key)
        while len(table) > self.max_entries:
            table.popitem(last=False)

    def lookup(self, tokens: list[int], *, boundary: bool = True
               ) -> list[int]:
        """Longest shareable run of pages for ``tokens`` (prefix order)."""
        ps = self.page_size
        n_full = len(tokens) // ps
        pages: list[int] = []
        for k in range(1, n_full + 1):
            page = self._get(self._chain, tuple(tokens[:k * ps]))
            if page is None:
                break
            pages.append(page)
        if boundary and len(pages) == n_full and len(tokens) % ps:
            page = self._get(self._boundary, tuple(tokens))
            if page is not None:
                pages.append(page)
        return pages

    def lookup_page(self, tokens: list[int], widx: int) -> Optional[int]:
        """Resident page for context page ``widx`` of ``tokens`` (exact
        prefix key), or None — O(prefix), for the growth-time re-share."""
        ps = self.page_size
        if (widx + 1) * ps <= len(tokens):
            return self._get(self._chain, tuple(tokens[:(widx + 1) * ps]))
        if len(tokens) % ps and widx == len(tokens) // ps:
            return self._get(self._boundary, tuple(tokens))
        return None

    def register(self, tokens: list[int], pages: list[int]) -> None:
        """Index a row's (so far) prefilled prompt pages — safe to call
        again as chunked admission maps more of the prompt."""
        ps = self.page_size
        n_full = len(tokens) // ps
        for k in range(1, min(n_full, len(pages)) + 1):
            key = tuple(tokens[:k * ps])
            if self._get(self._chain, key) is None:
                self._put(self._chain, key, pages[k - 1])
        npages = -(-len(tokens) // ps)
        if len(tokens) % ps and len(pages) >= npages:
            key = tuple(tokens)
            if self._get(self._boundary, key) is None:
                self._put(self._boundary, key, pages[npages - 1])

    def register_tail(self, tokens: list[int], pages: list[int]) -> None:
        """Index only the LAST page in ``pages`` (the page growth just
        mapped) — O(prefix) key material instead of re-keying every
        earlier page on every growth step."""
        ps = self.page_size
        k = len(pages)                    # pages cover prefix pages [0, k)
        if k == 0:
            return
        if k * ps <= len(tokens):         # page k-1 is full
            key = tuple(tokens[:k * ps])
            if self._get(self._chain, key) is None:
                self._put(self._chain, key, pages[k - 1])
        elif len(tokens) % ps and k == -(-len(tokens) // ps):
            key = tuple(tokens)           # the partial boundary page
            if self._get(self._boundary, key) is None:
                self._put(self._boundary, key, pages[k - 1])


class PrefixPageMapper:
    """Shared-prefix page mapping for a fixed-row agent engine (no COW).

    The orchestrator's agents re-contextualize in place: each (re-)prefill
    remaps the row's pages, sharing the full pages of any previously
    registered identical prefix — the CodeCRDT task/TODO prompt header —
    and allocating private pages for the rest of the row's horizon.  Only
    pages strictly below the row's first decode write are shared, so no
    copy-on-write is needed.  The pool holds ``(num_rows + 1) * maxp``
    pages (a row transiently holds old + new mappings during remap);
    unmapped table slots point at ``trash_page``, which lies past it.
    """

    def __init__(self, num_rows: int, maxp: int, page_size: int,
                 trash_page: int):
        self.allocator = PageAllocator((num_rows + 1) * maxp)
        if trash_page < self.allocator.num_pages:
            raise ValueError(
                f"trash_page {trash_page} lies inside the allocatable pool "
                f"[0, {self.allocator.num_pages}): decode writes of unmapped "
                "rows would corrupt live pages")
        self.prefix_cache = PrefixCache(self.allocator, page_size)
        self.page_size = page_size
        self.maxp = maxp
        self.trash_page = trash_page
        self.host_bt = np.full((num_rows, maxp), trash_page, np.int32)
        self._row_pages: list[list[int]] = [[] for _ in range(num_rows)]
        self.shared_pages = 0
        self._dirty = True                # initial table needs installing

    def map_row(self, row: int, tokens: list[int], horizon: int) -> int:
        """Remap ``row`` for a prompt of ``tokens`` and a total horizon of
        ``horizon`` positions (prompt + generation budget).  Returns the
        number of pages shared with previously mapped prompts."""
        ps = self.page_size
        npages = min(-(-horizon // ps), self.maxp)
        n_write = len(tokens) // ps       # decode writes from page n_write
        shared = self.prefix_cache.lookup(tokens, boundary=False)[:n_write]
        fresh = self.allocator.alloc(npages - len(shared))
        if fresh is None:
            raise RuntimeError("agent page pool exhausted")
        self.allocator.share(shared)
        pages = shared + fresh
        old = self._row_pages[row]
        self._row_pages[row] = pages
        self.host_bt[row, :] = self.trash_page
        self.host_bt[row, :len(pages)] = pages
        if old:
            self.allocator.free(old)      # after remap: self-prefix shares
        self.prefix_cache.register(tokens[:n_write * ps], pages[:n_write])
        self.shared_pages += len(shared)
        self._dirty = True
        return len(shared)

    def free_row(self, row: int) -> None:
        if self._row_pages[row]:
            self.allocator.free(self._row_pages[row])
            self._row_pages[row] = []
        self.host_bt[row, :] = self.trash_page
        self._dirty = True

    def install(self, cache: Params) -> Params:
        """Install the host block table into ``cache`` iff it changed since
        the last install (one host-to-device copy per batch of remaps)."""
        if self._dirty:
            cache = lm.set_block_tables(cache,
                                        torch.from_numpy(self.host_bt.copy()))
            self._dirty = False
        return cache


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    tokens: list[int] = field(default_factory=list)   # generated output
    admitted_step: int = -1
    first_token_step: int = -1        # step that emitted the first token
    finished_step: int = -1
    pages: list[int] = field(default_factory=list)
    filled: int = 0                   # prompt cursor: context tokens cached
    admit_len: int = 0                # admission target: len(context) at bind
    safe_upto: int = 0                # writes below this match shared bytes
    # -- lifecycle / SLO ----------------------------------------------------
    status: str = QUEUED
    priority: int = 0                 # higher = shed later, admitted earlier
    ttft_deadline: Optional[int] = None   # steps from submit to first token
    deadline: Optional[int] = None        # steps from submit to completion
    submitted_step: int = -1
    retries: int = 0                  # failover re-admissions so far
    max_retries: int = 2
    retry_at: int = 0                 # earliest step admission may bind this

    @property
    def context(self) -> list[int]:
        """Tokens the next admission must cover (prompt + generated so far —
        nonempty generated means the request was preempted and resumed)."""
        return self.prompt + self.tokens

    @property
    def admitting(self) -> bool:
        """Still streaming its admission context in (vs decoding)."""
        return self.filled < self.admit_len

    @property
    def terminal(self) -> bool:
        return self.status in (COMPLETED, SHED, EXPIRED, FAILED)


class ContinuousBatchingEngine:
    """Token-granularity continuous batching over a (paged) decode engine."""

    def __init__(self, cfg: ModelConfig, params: Params, *, batch: int,
                 max_len: int, paged: bool = True, page_size: int = 64,
                 num_pages: Optional[int] = None, impl: str = "kernel",
                 temperature: float = 0.0, seed: int = 0,
                 prefix_sharing: bool = False, chunk_size: int = 32,
                 token_budget: Optional[int] = None,
                 prefill_interleave: bool = True,
                 allocator: Optional[Any] = None,
                 prefix_cache: Optional[Any] = None,
                 max_queue: Optional[int] = None,
                 journal: Optional[Any] = None,
                 spec_decode: str = "off", kv_quant: str = "off",
                 swap_tier_pages: int = 0, role: str = "mixed",
                 device=None):
        if spec_decode != "off":
            raise _later("spec_decode", "item 8 (speculative decoding)")
        if swap_tier_pages:
            raise _later("swap_tier_pages", "item 9 (the swap tier)")
        if kv_quant != "off" and not paged:
            raise ValueError("kv_quant requires paged=True (quantized "
                             "layouts are page-pool layouts)")
        if role not in ("prefill", "decode", "mixed"):
            raise ValueError(f"role must be prefill/decode/mixed, "
                             f"got {role!r}")
        self.device = resolve_device(device)
        if params["embed"]["w"].device != self.device:
            raise ValueError(f"params live on {params['embed']['w'].device},"
                             f" the engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.batch = batch
        self.max_len = max_len
        self.paged = paged
        self.page_size = page_size
        self.impl = impl
        # Disaggregation: "prefill" replicas take cold prompts and publish
        # filled pages; "decode"/"mixed" replicas may carry an
        # ``adopt_hook`` (installed by the server) that pulls published
        # physical pages into this engine's pool at admission, skipping the
        # covered prefill.  The hook is ``(rid, ctx, shared) ->
        # (lead_pages, adopted_pages, covered_tokens)``: the row's full
        # leading page chain (every page already ref-held by the hook), the
        # subset that was physically transferred, and the cached leading
        # positions.
        self.role = role
        self.adopt_hook = None
        self.temperature = temperature
        self.prefix_sharing = prefix_sharing and paged
        self.chunk_size = max(1, min(chunk_size, max_len))
        self.token_budget = (max(1, token_budget)
                             if token_budget is not None else None)
        self.prefill_interleave = prefill_interleave
        self.maxp = -(-max_len // page_size)
        if paged:
            # Injectable backends: a replicated allocator / prefix cache
            # speaks the same API; the pool is sized to the allocator's
            # whole page space either way.
            if allocator is not None:
                num_pages = allocator.num_pages
            elif num_pages is None:
                num_pages = batch * self.maxp
            self.allocator = (PageAllocator(num_pages) if allocator is None
                              else allocator)
            self.prefix_cache = (PrefixCache(self.allocator, page_size)
                                 if prefix_cache is None else prefix_cache)
            self.trash_page = num_pages          # extra physical page
            self.cache = lm.init_cache(cfg, batch, max_len, paged=True,
                                       page_size=page_size,
                                       num_pages=num_pages + 1,
                                       kv_quant=kv_quant,
                                       device=self.device)
            self.host_bt = np.full((batch, self.maxp), self.trash_page,
                                   np.int32)
            self.cache = lm.set_block_tables(
                self.cache, torch.from_numpy(self.host_bt.copy()))
        else:
            self.allocator = None
            self.prefix_cache = None
            self.cache = lm.init_cache(cfg, batch, max_len,
                                       device=self.device)
        self._mixed = engine_mod.make_mixed_step_fn(cfg, impl=impl,
                                                    temperature=temperature)
        self._has_state = bool(lm.state_layers(cfg))
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        # Positions are host-owned: the mixed step takes (start, span) as
        # inputs, so the one per-step sync is reading the sampled tokens.
        self.row_pos = np.zeros((batch,), np.int64)   # tokens cached per row
        self.token = np.zeros((batch,), np.int64)     # last sampled token
        self.rows: list[Optional[Request]] = [None] * batch
        self.queue: deque[Request] = deque()
        self._bt_dirty = False
        self._last_alloc = [0] * batch        # LRU clock for preemption
        self._cow_src: list[int] = []         # COW pairs pending this step
        self._cow_dst: list[int] = []
        self._dev_memo: dict[str, tuple[np.ndarray, torch.Tensor]] = {}
        self.max_queue = max_queue
        self._journal = journal           # callable(kind, req) or None
        self.stats = {"steps": 0, "prefills": 0, "prefill_chunks": 0,
                      "admitted": 0, "completed": 0, "peak_pages": 0,
                      "gen_tokens": 0, "prefill_tokens": 0,
                      "shared_pages": 0, "cow_copies": 0, "preemptions": 0,
                      "grown_pages": 0, "admit_s": 0.0,
                      "decode_stall_steps": 0, "stalled_lane_steps": 0,
                      # Fault tolerance: totals plus per-cause counters.
                      "shed": 0, "shed_queue_full": 0, "shed_capacity": 0,
                      "expired": 0, "expired_ttft": 0, "expired_deadline": 0,
                      "expired_queued": 0, "retried": 0,
                      "preempt_for_pages": 0, "preempt_fenced": 0,
                      "preempt_recompute": 0,
                      # Disaggregation: physical pages adopted from peer
                      # pools, prompt tokens those pages covered, and
                      # prefill chunk steps that adoption skipped.
                      "adopted_pages": 0, "adopted_tokens": 0,
                      "prefill_steps_avoided": 0}

    # -- request lifecycle --------------------------------------------------

    def submit(self, req: Request) -> None:
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.rid}: max_new_tokens must be "
                             ">= 1 (admission always yields one token)")
        if not req.prompt:
            raise ValueError(f"request {req.rid}: empty prompt")
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            raise ValueError(f"request {req.rid} needs "
                             f"{len(req.prompt) + req.max_new_tokens} slots "
                             f"> max_len {self.max_len}")
        if self.paged:
            worst = -(-(len(req.prompt) + req.max_new_tokens)
                      // self.page_size)
            if worst > self.allocator.num_pages:
                raise ValueError(f"request {req.rid} needs {worst} pages "
                                 f"> pool {self.allocator.num_pages}")
        req.status = QUEUED
        req.submitted_step = self.stats["steps"]
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            # Bounded admission queue: shed the lowest-priority request
            # (ties toward the youngest) among the queue plus the newcomer
            # — backpressure never evicts higher-priority work.
            idx = min(range(len(self.queue)),
                      key=lambda i: (self.queue[i].priority, -i))
            victim = self.queue[idx]
            if req.priority <= victim.priority:
                self._shed(req, "shed_queue_full")
                return
            del self.queue[idx]
            self._shed(victim, "shed_queue_full")
        self.queue.append(req)

    def _terminate(self, req: Request, status: str, kind: str,
                   cause: str) -> None:
        req.status = status
        req.finished_step = self.stats["steps"]
        self.stats[kind] += 1
        self.stats[cause] += 1
        if self._journal is not None:
            self._journal(kind, req)

    def _shed(self, req: Request, cause: str) -> None:
        self._terminate(req, SHED, "shed", cause)

    def _expire(self, req: Request, cause: str) -> None:
        self._terminate(req, EXPIRED, "expired", cause)

    def _check_deadlines(self) -> None:
        """Drop queued and running requests whose TTFT / end-to-end deadline
        (in engine steps since submission) can no longer be met."""
        now = self.stats["steps"]

        def _late(req: Request) -> Optional[str]:
            if req.submitted_step < 0:
                return None
            age = now - req.submitted_step
            if (req.ttft_deadline is not None and req.first_token_step < 0
                    and age >= req.ttft_deadline):
                return "expired_ttft"
            if req.deadline is not None and age >= req.deadline:
                return "expired_deadline"
            return None

        if self.queue and any(_late(q) for q in self.queue):
            keep: deque[Request] = deque()
            for q in self.queue:
                if _late(q) is None:
                    keep.append(q)
                else:
                    self._expire(q, "expired_queued")
            self.queue = keep
        for row in range(self.batch):
            req = self.rows[row]
            if req is None:
                continue
            cause = _late(req)
            if cause is not None:
                self._release_row(row)
                self.rows[row] = None
                self.row_pos[row] = 0
                self._expire(req, cause)

    def _shed_on_capacity_loss(self) -> None:
        """A halted replica (retired by the majority) can never admit
        again: shed its queue, lowest priority first, so callers see SHED
        now instead of requests pinned forever."""
        if not self.queue or not getattr(self.allocator, "halted", False):
            return
        for q in sorted(self.queue, key=lambda q: (q.priority,
                                                   q.submitted_step)):
            self._shed(q, "shed_capacity")
        self.queue.clear()

    def _note_peak(self) -> None:
        used = self.allocator.num_pages - self.allocator.available
        self.stats["peak_pages"] = max(self.stats["peak_pages"], used)

    def _free_row(self, row: int) -> None:
        req = self.rows[row]
        req.finished_step = self.stats["steps"]
        req.status = COMPLETED
        self.stats["completed"] += 1
        if self._journal is not None:
            self._journal("done", req)
        self._release_row(row)
        self.rows[row] = None
        self.row_pos[row] = 0

    def _release_row(self, row: int) -> None:
        if self.paged:
            self.allocator.free(self.rows[row].pages, row=row)
            self.host_bt[row, :] = self.trash_page
            self._bt_dirty = True

    def _push_tables(self) -> None:
        if self._bt_dirty:
            self.cache = lm.set_block_tables(
                self.cache, torch.from_numpy(self.host_bt.copy()))
            self._bt_dirty = False

    def _chunk_pages(self, n_tokens: int) -> int:
        """Pages covering context positions [0, n_tokens)."""
        return -(-n_tokens // self.page_size)

    def _mark_filled(self, req: Request, upto: Optional[int] = None) -> None:
        """Tell a filled-page-tracking prefix cache (replicated serving)
        which of this row's pages physically hold their bytes.  Pages are
        published at reservation time, before the chunk writes land, so
        physical adoption gates on this; the host-local ``PrefixCache`` has
        no ``mark_filled``."""
        if self.prefix_cache is None:
            return
        mf = getattr(self.prefix_cache, "mark_filled", None)
        if mf is None or not req.pages:
            return
        n = int(req.filled if upto is None else upto)
        pages = req.pages[:n // self.page_size]
        if pages:
            mf(pages)

    def admit(self) -> int:
        """Bind queued requests to free rows (chunk-granular reservation).

        Pages for each candidate's FIRST chunk (past any shared prefix) are
        reserved (out of the free list at once, so later candidates see the
        true availability); later chunks and generation pages allocate as
        the prompt cursor advances.  Head-of-line blocking on page budget is
        deliberate (FIFO fairness).  Candidates go by priority, FIFO within
        a priority class; a request in retry backoff (``retry_at`` in the
        future) is skipped without blocking the requests behind it.
        """
        t0 = time.perf_counter()
        admitted = 0
        reset_rows = []
        now = self.stats["steps"]
        for row in range(self.batch):
            if self.rows[row] is not None or not self.queue:
                continue
            cand = None
            for i, q in enumerate(self.queue):
                if q.retry_at > now:
                    continue                   # backing off: not eligible yet
                if cand is None or q.priority > self.queue[cand].priority:
                    cand = i
            if cand is None:
                break                          # every queued request backs off
            req = self.queue[cand]
            ctx = req.context
            covered = 0
            if self.paged:
                first = (min(self.chunk_size, len(ctx))
                         if self.prefill_interleave else len(ctx))
                shared: list[int] = []
                if self.prefix_sharing:
                    shared = self.prefix_cache.lookup(ctx)[
                        :self._chunk_pages(len(ctx))]
                need = max(0, self._chunk_pages(first) - len(shared))
                res = self.allocator.reserve(need)
                if res is None:
                    break                      # wait for completions
                lead = shared
                if self.prefix_sharing and self.adopt_hook is not None:
                    # Disaggregated adoption: the hook walks the prompt's
                    # page chain, keeping filled local pages and pulling
                    # published peer pages (physical transfer + rule-3
                    # commit), and returns the row's leading chain with
                    # every page already ref-held.  ``covered`` prompt
                    # positions are then cached: admission streams only the
                    # tail.  Runs after ``reserve`` so a page-budget miss
                    # never strands a committed transfer.
                    lead, adopted, covered = self.adopt_hook(
                        req.rid, ctx, shared)
                    covered = max(0, min(covered, len(ctx) - 1))
                    self.stats["shared_pages"] += len(lead) - len(adopted)
                    if adopted:
                        self.stats["adopted_pages"] += len(adopted)
                    if covered:
                        self.stats["adopted_tokens"] += covered
                        full = -(-len(ctx) // self.chunk_size)
                        rest = -(-(len(ctx) - covered) // self.chunk_size)
                        self.stats["prefill_steps_avoided"] += full - rest
                elif shared:
                    self.allocator.share(shared, row=row)
                    self.stats["shared_pages"] += len(shared)
                req.pages = lead + res.take()
                req.safe_upto = min(len(lead) * self.page_size, len(ctx))
                self.host_bt[row, :] = self.trash_page
                self.host_bt[row, :len(req.pages)] = req.pages
                self._bt_dirty = True
                self._last_alloc[row] = self.stats["steps"]
                if self.prefix_sharing and not req.tokens:
                    # Register at reservation time: clones admitted while
                    # this prompt streams in share these pages, and the
                    # chunked writes land the identical prompt KV once per
                    # slot.  Sharers match on exact tokens, so the whole
                    # prompt is the registrant's safe region too.
                    self.prefix_cache.register(req.prompt, req.pages)
                    req.safe_upto = max(req.safe_upto, len(req.prompt))
            del self.queue[cand]
            self.rows[row] = req
            if req.retries and req.status == QUEUED:
                self.stats["retried"] += 1    # a backoff re-admission bound
            req.status = RUNNING
            req.filled = 0
            req.admit_len = len(ctx)
            req.admitted_step = self.stats["steps"]
            self.row_pos[row] = 0
            if covered:
                # Adopted / filled shared pages already hold positions
                # [0, covered): admission streams only the tail.
                req.filled = covered
                self.row_pos[row] = covered
            reset_rows.append(row)
            admitted += 1
        if admitted:
            if self._has_state:
                mask = np.zeros((self.batch,), bool)
                mask[reset_rows] = True
                self.cache = lm.reset_state_rows(self.cfg, self.cache,
                                                 torch.from_numpy(mask))
            self.stats["admitted"] += admitted
            if self.paged:
                self._note_peak()
        self.stats["admit_s"] += time.perf_counter() - t0
        return admitted

    def _done(self, req: Request) -> bool:
        return (len(req.tokens) >= req.max_new_tokens
                or (req.eos_id is not None
                    and req.tokens
                    and req.tokens[-1] == req.eos_id))

    # -- incremental growth / COW / preemption ------------------------------

    def _evict_row(self, victim: int, spans: np.ndarray, cause: str) -> None:
        """Release ``victim``'s pages and re-queue it at the front; it
        recomputes its context on re-admission.  Per-cause counters stay
        distinct."""
        req = self.rows[victim]
        self.stats["preempt_recompute"] += 1
        # A COW copy queued this step whose destination dies with the
        # victim is dropped: the freed page can be handed out again in this
        # same pass, and two copies into one page would race.
        dead = set(req.pages)
        keep = [(s, d) for s, d in zip(self._cow_src, self._cow_dst)
                if d not in dead]
        self._cow_src = [s for s, _ in keep]
        self._cow_dst = [d for _, d in keep]
        self._release_row(victim)
        self.rows[victim] = None
        req.status = PREEMPTED
        self.queue.appendleft(req)             # resumes with context intact
        self.row_pos[victim] = 0
        spans[victim] = 0                      # no span for the evicted row
        self.stats["preemptions"] += 1
        self.stats[cause] += 1

    def _preempt_for_pages(self, needy_row: int, spans: np.ndarray) -> bool:
        """Evict the least-recently-allocating other row (recomputation)."""
        victims = [r for r in range(self.batch)
                   if r != needy_row and self.rows[r] is not None]
        if not victims:
            return False
        victim = min(victims, key=lambda r: (self._last_alloc[r], r))
        self._evict_row(victim, spans, "preempt_for_pages")
        return True

    def _alloc_blocked(self) -> bool:
        """True while the allocator refuses ALL allocation for reasons no
        preemption can fix: a replicated allocator that is fenced (a peer is
        unheard) or halted (retired by the majority)."""
        a = self.allocator
        if getattr(a, "halted", False):
            return True
        fenced = getattr(a, "fenced", None)
        return bool(fenced is not None and fenced(getattr(a, "now", 0)))

    def _alloc_one(self, row: int, spans: np.ndarray) -> int:
        """One page for ``row``, preempting other rows while the pool is
        empty.  Returns -1 when allocation is fenced / halted shut: the
        needy row itself is preempted (it resumes once the allocator
        unblocks)."""
        while True:
            pages = self.allocator.alloc(1)
            if pages is not None:
                self._last_alloc[row] = self.stats["steps"]
                return pages[0]
            if self._alloc_blocked():
                self._evict_row(row, spans, "preempt_fenced")
                return -1
            if not self._preempt_for_pages(row, spans):
                raise RuntimeError(
                    f"page pool exhausted ({self.allocator.num_pages} pages)"
                    " with no preemptable row — pool too small for one "
                    "request")

    def _ensure_pages(self, spans: np.ndarray) -> None:
        """Before the mixed step: every row must own, privately, each page
        its span will write.  Crossing into an unallocated page allocates
        one; a page shared with other rows or the prefix cache is
        duplicated and remapped (copy-on-write) — unless every position
        written into it lies below the row's shared-prefix match
        (``safe_upto``), where the bytes are identical by construction."""
        self._cow_src = []
        self._cow_dst = []
        for row in range(self.batch):
            req = self.rows[row]
            if req is None or spans[row] == 0:
                continue
            w0 = int(self.row_pos[row])
            w1 = w0 + int(spans[row])          # writes cover [w0, w1)
            for widx in range(w0 // self.page_size,
                              (w1 - 1) // self.page_size + 1):
                if widx >= self.maxp:
                    continue                   # clamped write; cannot grow
                if self.rows[row] is not req:
                    break                      # row was preempted mid-walk
                page = int(self.host_bt[row, widx])
                lo = max(w0, widx * self.page_size)
                hi = min(w1, (widx + 1) * self.page_size)
                if page == self.trash_page:
                    if self.prefix_sharing and req.admitting:
                        # Growth-time re-share: a page already resident for
                        # the identical context prefix (a concurrent clone)
                        # is aliased instead of allocated.
                        pg = self.prefix_cache.lookup_page(req.context,
                                                           widx)
                        if pg is not None:
                            self.allocator.share([pg], row=row)
                            self.host_bt[row, widx] = pg
                            req.pages.append(pg)
                            self._bt_dirty = True
                            self.stats["shared_pages"] += 1
                            req.safe_upto = max(
                                req.safe_upto,
                                min((widx + 1) * self.page_size,
                                    len(req.context)))
                            continue
                    new = self._alloc_one(row, spans)
                    if new < 0:
                        break              # fenced: the row self-preempted
                    if self.rows[row] is not req:
                        self.allocator.free([new])
                        break
                    self.host_bt[row, widx] = new
                    req.pages.append(new)
                    self._bt_dirty = True
                    self.stats["grown_pages"] += 1
                    if (self.prefix_sharing and req.admitting
                            and not req.tokens):
                        # Index the freshly grown prompt page at once so
                        # clones growing later in this pass share it.
                        self.prefix_cache.register_tail(req.prompt,
                                                        req.pages)
                elif (self.allocator.refcount(page) > 1
                        and max(lo, req.safe_upto) < hi):
                    new = self._alloc_one(row, spans)
                    if new < 0:
                        break              # fenced: the row self-preempted
                    if self.rows[row] is not req:
                        self.allocator.free([new])
                        break
                    self._cow_src.append(page)
                    self._cow_dst.append(new)
                    self.host_bt[row, widx] = new
                    req.pages[req.pages.index(page)] = new
                    self.allocator.free([page], row=row)  # drop shared ref
                    self._bt_dirty = True
                    self.stats["cow_copies"] += 1
        if self._cow_src:
            self.cache = lm.copy_pages(self.cache, self._cow_src,
                                       self._cow_dst)
        self._cow_src = []
        self._cow_dst = []
        self._note_peak()
        self._push_tables()

    # -- token-budget composer + mixed step ---------------------------------

    def _compose(self) -> np.ndarray:
        """Per-row spans for this step: decode rows are funded first (one
        token each), then prompt chunks split the remaining budget.  Under
        a constraining budget, funding order rotates with the step counter
        so no fixed row index is starved indefinitely."""
        spans = np.zeros((self.batch,), np.int64)
        rot = self.stats["steps"] % self.batch
        order = sorted(range(self.batch),
                       key=lambda r: (r - rot) % self.batch)
        decoding = [r for r in order
                    if self.rows[r] is not None
                    and not self.rows[r].admitting]
        admitting = [r for r in order
                     if self.rows[r] is not None and self.rows[r].admitting]
        budget = self.token_budget if self.token_budget is not None \
            else self.batch * self.chunk_size
        if admitting and not self.prefill_interleave:
            # Stalled-admission baseline: prompts land whole, decode lanes
            # idle while any admission is in flight.
            if decoding:
                self.stats["decode_stall_steps"] += 1
                self.stats["stalled_lane_steps"] += len(decoding)
            for r in admitting:
                req = self.rows[r]
                spans[r] = req.admit_len - req.filled
            return spans
        starved = 0
        for r in decoding:
            if budget <= 0:
                starved += 1
                continue
            spans[r] = 1
            budget -= 1
        if starved:
            self.stats["decode_stall_steps"] += 1
            self.stats["stalled_lane_steps"] += starved
        for r in admitting:
            if budget <= 0:
                break
            req = self.rows[r]
            take = min(self.chunk_size, req.admit_len - req.filled, budget)
            spans[r] = take
            budget -= take
        return spans

    def _to_dev(self, name: str, arr: np.ndarray) -> torch.Tensor:
        """Upload ``arr`` unless it is unchanged since the last step."""
        memo = self._dev_memo.get(name)
        if memo is not None and np.array_equal(memo[0], arr):
            return memo[1]
        dev = torch.from_numpy(arr).to(self.device)
        self._dev_memo[name] = (arr.copy(), dev)
        return dev

    # -- decode loop --------------------------------------------------------

    def step(self) -> bool:
        """One token-budget mixed step.  Returns False when fully drained."""
        self._check_deadlines()
        self._shed_on_capacity_loss()
        self.admit()
        if all(r is None for r in self.rows):
            if self.queue:
                # Nothing bound (every queued request backing off or blocked
                # on pages): the clock still ticks, or retry_at never comes.
                self.stats["steps"] += 1
                return True
            return False
        spans = self._compose()
        if self.paged:
            self._ensure_pages(spans)
        if not spans.any():
            self.stats["steps"] += 1           # budget 0: bookkeeping step
            return True
        clamp = (max(self.chunk_size, 1) if self.prefill_interleave
                 else self.max_len)
        width = engine_mod.width_bucket(int(spans.max()), clamp)
        toks = np.zeros((self.batch, width), np.int64)
        for row in range(self.batch):
            req = self.rows[row]
            if req is None or spans[row] == 0:
                continue
            if req.admitting:
                seg = req.context[req.filled: req.filled + int(spans[row])]
                toks[row, :len(seg)] = seg
            else:
                toks[row, 0] = self.token[row]
        nxt, self.cache = self._mixed(
            self.params, self.cache,
            self._to_dev(f"tok{width}", toks.astype(np.int32)),
            self._to_dev("start", self.row_pos.astype(np.int32)),
            self._to_dev(f"span{width}", spans.astype(np.int32)), self.gen)
        sampled = nxt.cpu().numpy()            # the one per-step sync
        self.stats["steps"] += 1
        chunks = 0
        freed = False
        for row in range(self.batch):
            req = self.rows[row]
            if req is None or spans[row] == 0:
                continue
            self.row_pos[row] += int(spans[row])
            if req.admitting:
                req.filled += int(spans[row])
                chunks += 1
                self.stats["prefill_tokens"] += int(spans[row])
                if req.admitting:
                    self._mark_filled(req)
                    continue                  # mid-prompt logits: discarded
                # Admission complete: this chunk's last logits sampled the
                # first token (TTFT below keeps a resumed request's first).
                if self.prefix_sharing and not req.tokens:
                    self.prefix_cache.register(req.prompt, req.pages)
            self._mark_filled(req, upto=int(self.row_pos[row]))
            self.token[row] = int(sampled[row])
            req.tokens.append(int(sampled[row]))
            self.stats["gen_tokens"] += 1
            if self._journal is not None:
                self._journal("gen", req)
            if req.first_token_step < 0:
                req.first_token_step = self.stats["steps"]
            if self._done(req):
                self._free_row(row)
                freed = True
        if chunks:
            self.stats["prefill_chunks"] += chunks
            self.stats["prefills"] += 1        # steps that carried a chunk
        if freed:
            self.admit()
        return any(r is not None for r in self.rows) or bool(self.queue)

    def run(self, requests: list[Request], max_steps: int = 100_000
            ) -> list[Request]:
        for r in requests:
            self.submit(r)
        for _ in range(max_steps):
            if not self.step():
                break
        else:
            raise RuntimeError("scheduler hit max_steps with work remaining")
        return requests
