"""Hopper kernel: single-query attention over a dense KV cache with a
per-row valid length (GQA, no window).

Replaces ``src/repro/kernels/decode_attention.py`` · ``decode_attention``;
the CUDA source and its design notes are in ``csrc/decode_attention.cu``.
Callers go through ``ops.decode_attention``, which sends CPU tensors to
``ref``.  Unlike the TPU wrapper, nothing is padded: the walk stops at each
row's ``kv_len``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _b

NAME = "decode_attention"
_ARGTYPES = [_b.INT] + [_b.PTR] * 5 + [_b.INT] * 5 + [_b.FLOAT, _b.PTR]

launches = 0            # kernel launches through this wrapper


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, *, scale: float) -> torch.Tensor:
    """q: [B, Hq, D]; k, v: [B, Hkv, S, D] (q's dtype); kv_len: i32[B].
    Returns out [B, Hq, D] (zero for rows with kv_len 0)."""
    global launches
    b, hq, d = q.shape
    _, hkv, s, _ = k.shape
    dev = q.device
    code = _b.check_dims(NAME, q.dtype, d, _b.DENSE_HEAD_DIMS)
    if hq % hkv or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{NAME}: q {tuple(q.shape)} does not fit the "
                         f"cache {tuple(k.shape)}")
    out = torch.empty_like(q)
    args = [_b.ptr(NAME, "q", q, dev, dtype=q.dtype),
            _b.ptr(NAME, "out", out, dev),
            _b.ptr(NAME, "k", k, dev, dtype=q.dtype),
            _b.ptr(NAME, "v", v, dev, dtype=q.dtype, shape=k.shape),
            _b.ptr(NAME, "kv_len", kv_len, dev, dtype=torch.int32,
                   shape=(b,))]
    lib = _b.load(NAME, _ARGTYPES)
    with torch.cuda.device(dev):
        status = lib.decode_attention(code, *args, b, hq, hkv, s, d, scale,
                                      _b.stream(dev))
    launches += 1
    _b.raise_on_error(NAME, lib, status)
    return out
