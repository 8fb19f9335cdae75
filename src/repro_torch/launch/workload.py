"""The full-width serving workload, defined once.

``chip_smoke.py`` checks it and ``launch/profile_serve.py`` profiles it, so
both measure the same traffic: ``olmo-1b`` with seeded random bf16
weights behind ``ContinuousBatchingEngine(batch=8, max_len=1024,
page_size=16, chunk_size=64)``, answering 16 requests whose prompts are
32–512 tokens long, with 32 new tokens each.
"""
from __future__ import annotations

import numpy as np

from repro_torch.models.config import ModelConfig
from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

ARCH = "olmo-1b"
ENGINE = dict(batch=8, max_len=1024, page_size=16, chunk_size=64)
N_REQUESTS = 16
PROMPT_LENS = (32, 512)             # inclusive
NEW_TOKENS = 32


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
