"""The full-width serving workloads, defined once.

``chip_smoke.py`` checks them and ``launch/profile_serve.py`` profiles
each, so both measure the same traffic: seeded random bf16 weights behind
``ContinuousBatchingEngine(batch=8, max_len=1024, page_size=16,
chunk_size=64)``, answering 16 requests whose prompts are 32–512 tokens
long, with 32 new tokens each, on

* ``olmo-1b`` (``ARCH``): dense MHA, the agents' model family;
* ``mla_config()``: DeepSeek-V2-Lite's published widths (27 layers,
  d_model 2048, 16 heads, vocab 102400, MLA kv_lora_rank 512 with a
  64-wide RoPE key; arXiv:2405.04434, deepseek-ai/DeepSeek-V2-Lite
  ``config.json``) with every layer dense: MLA attention and the model's
  own dense FFN width, ``intermediate_size`` 10944 (its first layer,
  ``first_k_dense_replace: 1``), in place of the MoE FFN the port does not
  run yet (ROADMAP.md queue 1 item 11).  About 2.6 B parameters;
* ``recurrentgemma-2b`` (``RECURRENT_ARCH``, arXiv:2402.19427, the repo's
  own config at full width): 26 layers, 8 × (rglru, rglru, local) and a
  tail of (rglru, rglru), d_model 2560, 10 query heads on 1 KV head of
  256, window 2048, RG-LRU width 2560.  2.89 B parameters.  Its windowed
  layers keep a dense cache and its recurrent layers a state, so
  ``paged=True`` pages no layer: the scheduler only keeps its page
  accounting.

The disaggregated workload (``DISAGG``) serves ``olmo-1b`` from two
engines on one replicated page table, one prefill and one decode replica
(``serving/replicated.MultiEngineServer``): 8 requests over two seeded
prompts of 261 tokens (16 full pages of 16 and 5 more), 32 new tokens
each, in the arrival pattern of ``benchmarks/bench_serving.run_disagg``:
the first ``batch`` at step 0 (cold: the prefill replica takes them), the
rest one per step (warm: the decode replica adopts the published pages).
"""
from __future__ import annotations

import numpy as np

from repro_torch import configs
from repro_torch.models.config import ModelConfig
from repro_torch.serving.replicated import MultiEngineServer
from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

ARCH = "olmo-1b"
MLA_BASE = "deepseek-v2-lite-16b"
MLA_DENSE_FFN = 10944               # DeepSeek-V2-Lite intermediate_size
RECURRENT_ARCH = "recurrentgemma-2b"
ENGINE = dict(batch=8, max_len=1024, page_size=16, chunk_size=64)
N_REQUESTS = 16
PROMPT_LENS = (32, 512)             # inclusive
NEW_TOKENS = 32


def mla_config() -> ModelConfig:
    """``deepseek-v2-lite-16b`` with dense FFNs in every layer."""
    return configs.get(MLA_BASE).replace(
        name="deepseek-v2-lite-mla-dense", block_pattern=("mla",), moe=None,
        d_ff=MLA_DENSE_FFN)


def requests(vocab: int, seed: int = 0) -> list[Request]:
    """The workload's requests, drawn afresh from ``seed``."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, N_REQUESTS)
    return [Request(i, rng.integers(0, vocab, int(n)).tolist(), NEW_TOKENS)
            for i, n in enumerate(lens)]


def engine(cfg: ModelConfig, params, **kw) -> ContinuousBatchingEngine:
    """The workload's scheduler; ``kw`` adds ``impl``, ``device`` and the
    like, never one of ``ENGINE``'s sizes."""
    return ContinuousBatchingEngine(cfg, params, **ENGINE, **kw)


DISAGG = dict(batch=4, max_len=1024, page_size=16, chunk_size=16,
              sync_every=1,
              # A 261-token prompt journals 262 entries per request: the
              # journal ships up to 2048 entries a gossip round and holds
              # 4096 a lane, so a crashed exporter's descriptors have
              # reached its peers before its first transfer.
              journal_delta_capacity=2048, journal_capacity=4096)
DISAGG_REQUESTS = 8
DISAGG_PROMPT = 261
DISAGG_NEW = 32


def disagg_requests(vocab: int, seed: int = 0) -> list[Request]:
    """AABBAABB over two seeded prompts (request i takes prompt
    (i // 2) % 2)."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(2, vocab, DISAGG_PROMPT).tolist()
               for _ in range(2)]
    return [Request(rid=i, prompt=list(prompts[(i // 2) % 2]),
                    max_new_tokens=DISAGG_NEW)
            for i in range(DISAGG_REQUESTS)]


def disagg_server(cfg: ModelConfig, params, *, replicas: int = 2,
                  **kw) -> MultiEngineServer:
    """One prefill replica and ``replicas - 1`` decode replicas on one
    parameter tree; ``kw`` adds ``impl``, ``device``, ``kv_quant``,
    ``adopt_pages`` and the like."""
    return MultiEngineServer(
        cfg, params, replicas=replicas,
        roles=["prefill"] + ["decode"] * (replicas - 1), **DISAGG, **kw)


def run_disagg(server: MultiEngineServer, reqs: list[Request],
               max_steps: int = 20_000) -> list[float]:
    """Serve ``reqs``: the first ``batch`` submitted at step 0, the rest
    one per step; then a final gossip round.  Returns each step's wall
    time in seconds."""
    import time
    pending = list(reqs)
    for r in pending[:DISAGG["batch"]]:
        server.submit(r)
    pending = pending[DISAGG["batch"]:]
    walls = []
    while True:
        t0 = time.perf_counter()
        more = server.step()
        walls.append(time.perf_counter() - t0)
        if pending:
            server.submit(pending.pop(0))
            more = True
        if not more:
            break
        if server.clock > max_steps:
            raise RuntimeError(f"disaggregated serving ran past {max_steps} "
                               "steps")
    server.sync()
    return walls
