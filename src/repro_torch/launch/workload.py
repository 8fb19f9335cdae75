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
  ``first_k_dense_replace: 1``).  About 2.6 B parameters.  The MoE FFN is
  ported (``MOE_ARCH`` below); this dense-FFN model stays the workload of
  the MLA kernel rows and of trial (e);
* ``deepseek-v2-lite-16b`` (``MOE_ARCH``): the repo's config as it is,
  27 ``mla_moe`` layers, each MLA attention and an MoE FFN of 64 routed
  experts (top 6) and 2 shared ones, of width 1408.  16.2 B parameters; a
  step reads every expert's weights, 27 × 66 × 3 × 2048 × 1408 × 2 B ≈
  30.8 GB;
* ``deepseek-moe-16b`` (``DENSE_MOE_ARCH``, arXiv:2401.06066): 28 ``moe``
  layers, full MHA attention (16 heads of 128) and the same MoE FFN.
  16.9 B parameters;
* ``xlstm-125m`` (``XLSTM_ARCH``, arXiv:2405.04517): 12 layers alternating
  sLSTM and mLSTM, d_model 768, 4 heads, vocabulary 50304.  Its layers
  hold recurrent states only, so ``paged=True`` pages nothing;
* ``recurrentgemma-2b`` (``RECURRENT_ARCH``, arXiv:2402.19427, the repo's
  own config at full width): 26 layers, 8 × (rglru, rglru, local) and a
  tail of (rglru, rglru), d_model 2560, 10 query heads on 1 KV head of
  256, window 2048, RG-LRU width 2560.  2.89 B parameters.  Its windowed
  layers keep a dense cache and its recurrent layers a state, so
  ``paged=True`` pages no layer: the scheduler only keeps its page
  accounting.

The swap workload (``SWAP``) serves OLMo-1B's 16 requests from a pool of
96 pages (about 2 MB a bf16 page: 16 layers' K and V of 16 tokens), far
below the 512 the 8 rows could hold, so growth preempts; a host swap tier
of 256 pages takes the victims' pages instead of recomputing them.

The whisper workload (``WHISPER``) serves ``whisper-tiny`` at full width
(arXiv:2212.04356, the repo's config: a 4-layer encoder over 1500 stub
frame embeddings, a 4-layer decoder with cross-attention, d_model 384, 6
heads of 64, vocabulary 51865) through ``Engine(batch=8, max_len=256)``:
seeded random bf16 weights and bf16 frames [8, 1500, 384], 32-token
prompts and 32 new tokens.  Its prefill runs the encoder on
``flash_attention`` and its decode steps ``decode_attention`` at head_dim
64.

The PaliGemma workload (``PALIGEMMA``) serves ``paligemma-3b`` at full
width (arXiv:2407.07726, the repo's config: 18 layers, d_model 2048, 8
query heads on 1 KV head of 256, a GeGLU FFN of 16384, vocabulary 257216,
tied and scaled embeddings; about 2.5 B parameters, 5 GB in bf16) through
``Engine(batch=8, max_len=512)`` on a dense cache and on pages of 16:
seeded random bf16 weights and seeded bf16 stub patch embeddings
[8, 256, 2048] (the SigLIP tower is a stub, as in JAX), 32-token prompts
and 32 new tokens.  Its prefill is the prefix-LM's masked attention over
288 positions; its decode steps run ``decode_attention`` (dense) or
``paged_decode_attention`` (paged) at head_dim 256, a group of 8.

The long-prompt workload (``LONG``) prefills ``olmo-1b`` with one prompt
of 16,384 tokens, past ``lm.CHUNKED_THRESHOLD`` (8192), through a dense
``Engine(batch=1)``: the blockwise attention path, then decode steps on
``decode_attention`` over more than 16k keys.

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
import torch

from repro_torch import configs, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.serving.engine import Engine
from repro_torch.serving.replicated import MultiEngineServer
from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

ARCH = "olmo-1b"
MLA_BASE = "deepseek-v2-lite-16b"
MLA_DENSE_FFN = 10944               # DeepSeek-V2-Lite intermediate_size
MOE_ARCH = "deepseek-v2-lite-16b"
DENSE_MOE_ARCH = "deepseek-moe-16b"
RECURRENT_ARCH = "recurrentgemma-2b"
XLSTM_ARCH = "xlstm-125m"
ENGINE = dict(batch=8, max_len=1024, page_size=16, chunk_size=64)
N_REQUESTS = 16
PROMPT_LENS = (32, 512)             # inclusive
NEW_TOKENS = 32


SWAP = dict(num_pages=96, swap_tier_pages=256)


def mla_config() -> ModelConfig:
    """``deepseek-v2-lite-16b`` with dense FFNs in every layer: the MLA
    kernel rows' workload (the MoE FFN is ported; ``MOE_ARCH`` serves the
    model as it is)."""
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


WHISPER_ARCH = "whisper-tiny"
WHISPER = dict(batch=8, max_len=256)
WHISPER_PROMPT = 32
WHISPER_NEW = 32


def whisper_inputs(cfg: ModelConfig, seed: int = 0, device=None
                   ) -> tuple[np.ndarray, torch.Tensor]:
    """Seeded prompts [batch, WHISPER_PROMPT] and bf16 stub frames
    [batch, encoder.seq_len, d_model] on ``device`` (the card unless
    ``"cpu"``)."""
    rng = np.random.default_rng(seed)
    b = WHISPER["batch"]
    tokens = rng.integers(0, cfg.vocab_size, (b, WHISPER_PROMPT))
    frames = rng.standard_normal((b, cfg.encoder.seq_len, cfg.d_model),
                                 dtype=np.float32)
    return tokens, torch.from_numpy(frames).to(
        resolve_device(device)).bfloat16()


def whisper_engine(cfg: ModelConfig, params, **kw) -> Engine:
    """The whisper workload's engine; ``kw`` adds ``impl``, ``device``."""
    return Engine(cfg, params, **WHISPER, **kw)


PALIGEMMA_ARCH = "paligemma-3b"
PALIGEMMA = dict(batch=8, max_len=512, page_size=16)
PALIGEMMA_PROMPT = 32
PALIGEMMA_NEW = 32


def paligemma_inputs(cfg: ModelConfig, seed: int = 0, device=None
                     ) -> tuple[np.ndarray, torch.Tensor]:
    """Seeded prompts [batch, PALIGEMMA_PROMPT] and bf16 stub patch
    embeddings [batch, num_prefix_tokens, d_model] on ``device`` (the card
    unless ``"cpu"``)."""
    rng = np.random.default_rng(seed)
    b = PALIGEMMA["batch"]
    tokens = rng.integers(0, cfg.vocab_size, (b, PALIGEMMA_PROMPT))
    prefix = rng.standard_normal((b, cfg.num_prefix_tokens, cfg.d_model),
                                 dtype=np.float32)
    return tokens, torch.from_numpy(prefix).to(
        resolve_device(device)).bfloat16()


def paligemma_engine(cfg: ModelConfig, params, **kw) -> Engine:
    """The PaliGemma workload's engine; ``kw`` adds ``paged``, ``impl``,
    ``device``."""
    return Engine(cfg, params, **PALIGEMMA, **kw)


LONG_PROMPT = 16_384
LONG_NEW = 8
LONG = dict(batch=1, max_len=LONG_PROMPT + LONG_NEW)


def long_prompt(vocab: int, seed: int = 0) -> np.ndarray:
    """The long-prompt workload's one prompt [1, LONG_PROMPT]."""
    return np.random.default_rng(seed).integers(0, vocab, (1, LONG_PROMPT))


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
