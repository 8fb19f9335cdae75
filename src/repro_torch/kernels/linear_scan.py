"""Hopper kernel: the diagonal linear recurrence h_t = a_t ⊙ h_{t-1} + b_t
of the RG-LRU.

Replaces ``src/repro/kernels/rglru_scan.py`` · ``linear_scan``; the CUDA
source and its design notes are in ``csrc/linear_scan.cu``.  Callers go
through ``ops.linear_scan``, which sends CPU tensors to ``ref``.  Unlike
the TPU wrapper, time is not padded to a block multiple: the walk stops at
T.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _b

NAME = "linear_scan"
_ARGTYPES = [_b.INT] + [_b.PTR] * 5 + [_b.INT] * 3 + [_b.PTR]

launches = 0            # kernel launches through this wrapper


def linear_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """a: float32 [B, T, D]; b: [B, T, D] float32 or bf16; h0: float32
    [B, D].  Returns (y [B, T, D] in b's dtype, h_T float32 [B, D])."""
    global launches
    bsz, t, d = a.shape
    dev = a.device
    code = _b.dtype_code(NAME, b.dtype)
    y = torch.empty_like(b)
    h_t = torch.empty((bsz, d), dtype=torch.float32, device=dev)
    args = [_b.ptr(NAME, "a", a, dev, dtype=torch.float32),
            _b.ptr(NAME, "b", b, dev, shape=a.shape),
            _b.ptr(NAME, "h0", h0, dev, dtype=torch.float32,
                   shape=(bsz, d)),
            _b.ptr(NAME, "y", y, dev),
            _b.ptr(NAME, "h_t", h_t, dev)]
    lib = _b.load(NAME, _ARGTYPES)
    with torch.cuda.device(dev):
        status = lib.linear_scan(code, *args, bsz, t, d, _b.stream(dev))
    launches += 1
    _b.raise_on_error(NAME, lib, status)
    return y, h_t
