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
"""
from __future__ import annotations

import numpy as np

from repro_torch import configs
from repro_torch.models.config import ModelConfig
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
