"""Hopper kernel: blocked online-softmax attention over whole sequences
(GQA, causal or not, an optional sliding window, Tq != Tk end-aligned).

Replaces ``src/repro/kernels/flash_attention.py`` · ``flash_attention``; the
CUDA source and its design notes are in ``csrc/flash_attention.cu``.
Callers go through ``ops.flash_attention``, which sends CPU tensors to
``ref``.  Unlike the TPU wrapper, nothing is padded: Tq and Tk are masked
at their true lengths and head_dim is not widened to 128.  A query row with
no live key comes out 0 (the plain version gives NaN).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _b

NAME = "flash_attention"
_ARGTYPES = ([_b.INT] + [_b.PTR] * 4 + [_b.INT] * 6 + [_b.FLOAT]
             + [_b.INT] * 3 + [_b.PTR])
HEAD_DIMS = tuple(range(16, 129, 16))   # any multiple of 16 up to 128

launches = 0            # kernel launches through this wrapper


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, scale: float,
                    window: int | None) -> torch.Tensor:
    """q: [B, Hq, Tq, D]; k, v: [B, Hkv, Tk, D], all one dtype (float32 or
    bf16).  Returns out [B, Hq, Tq, D] in q's dtype."""
    global launches
    b, hq, tq, d = q.shape
    dev = q.device
    code = _b.check_dims(NAME, q.dtype, d, HEAD_DIMS)
    if (k.dim() != 4 or k.shape[0] != b or k.shape[3] != d
            or k.shape[1] == 0 or hq % k.shape[1]):
        raise ValueError(f"{NAME}: q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)}")
    hkv, tk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    args = [_b.ptr(NAME, "q", q, dev),
            _b.ptr(NAME, "k", k, dev, dtype=q.dtype),
            _b.ptr(NAME, "v", v, dev, dtype=q.dtype, shape=k.shape),
            _b.ptr(NAME, "out", out, dev)]
    if out.numel() == 0:
        return out
    lib = _b.load(NAME, _ARGTYPES)
    with torch.cuda.device(dev):
        status = lib.flash_attention(
            code, *args, b, hq, hkv, tq, tk, d, scale, int(causal),
            int(window is not None), 0 if window is None else int(window),
            _b.stream(dev))
    launches += 1
    _b.raise_on_error(NAME, lib, status)
    return out
