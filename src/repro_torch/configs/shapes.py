"""Input-shape sets and (arch × shape) applicability, as in
``repro.configs.shapes``.

Four LM shapes (seq_len × global_batch):
  train_4k     4_096 × 256   training step
  prefill_32k  32_768 × 32   prefill (the prompt pass; past
                             ``lm.CHUNKED_THRESHOLD`` it runs blockwise)
  decode_32k   32_768 × 128  one new token over a 32k cache
  long_500k    524_288 × 1   decode; only sub-quadratic architectures

long_500k is skipped for pure full-attention architectures (granite, olmo,
command-r+, starcoder2, both deepseeks, paligemma) and for the
encoder-decoder audio architecture (whisper).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable(arch_cfg, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch, shape) cell."""
    if shape.name == "long_500k":
        if arch_cfg.is_encdec:
            return False, "enc-dec audio arch: 500k-token decode undefined"
        if not arch_cfg.sub_quadratic:
            return False, ("pure full-attention arch: needs sub-quadratic "
                           "attention")
    return True, ""
