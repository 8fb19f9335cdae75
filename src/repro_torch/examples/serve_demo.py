"""Serving demo: batched requests through the engine (prefill + decode),
the port's copy of the JAX package's ``examples/serve_demo.py``.

Four requests share one decode batch; per-row positions support continuous
batching.  Works with any registered arch (reduced config).

    PYTHONPATH=src python -m repro_torch.examples.serve_demo [arch] \\
        [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

import repro_torch.configs as configs
from repro_torch.models import lm
from repro_torch.serving.engine import Engine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch", nargs="?", default="recurrentgemma-2b")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = configs.reduced(configs.get(args.arch))
    params = lm.init(cfg, seed=0, device=args.device)
    dev = params["embed"]["w"].device

    B, P, STEPS = 4, 8, 12
    engine = Engine(cfg, params, batch=B,
                    max_len=P + STEPS + cfg.num_prefix_tokens + 2,
                    device=dev)

    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(2, cfg.vocab_size, (B, P)),
                              dtype=torch.int32, device=dev)
    stubs = {}
    if cfg.num_prefix_tokens:
        stubs["prefix_embeds"] = torch.as_tensor(
            rng.normal(size=(B, cfg.num_prefix_tokens, cfg.d_model)),
            dtype=torch.bfloat16, device=dev)
    if cfg.is_encdec:
        stubs["enc_frames"] = torch.as_tensor(
            rng.normal(size=(B, cfg.encoder.seq_len, cfg.d_model)),
            dtype=torch.bfloat16, device=dev)

    print(f"arch={args.arch} (reduced: L={cfg.num_layers} d={cfg.d_model}) "
          f"batch={B} prompt={P} steps={STEPS}")
    out = engine.generate(prompts, STEPS, **stubs)
    print("generated token grid [B, steps]:")
    print(out.cpu().numpy())
    print("per-row positions:", engine.pos.cpu().numpy())


if __name__ == "__main__":
    main()
