"""Hopper kernel: the LWW join of two register banks (the larger key wins
and its payload row comes with it; on equal keys bank ``a`` wins).

Replaces ``src/repro/kernels/lww_merge.py`` · ``lww_merge``; the CUDA
source and its design notes are in ``csrc/lww_merge.cu``.  Callers go
through ``ops.lww_merge``, which checks the contract and sends CPU tensors
to ``ref``.  Payload rows are copied as bytes, so every dtype takes the
same kernel; nothing is padded to the TPU's 128-lane tiles.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as _b

NAME = "lww_merge"
_LL = ctypes.c_longlong
_ARGTYPES = [_b.PTR] * 6 + [_LL, _LL, _b.PTR]

launches = 0            # kernel launches through this wrapper


def lww_merge(key_a: torch.Tensor, pay_a: torch.Tensor, key_b: torch.Tensor,
              pay_b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """key_a, key_b: int32 [K]; pay_a, pay_b: [K, ...] of one shape and
    dtype, all contiguous on one card.  Returns new (key, pay)."""
    global launches
    dev = key_a.device
    key_o = torch.empty_like(key_a)
    pay_o = torch.empty_like(pay_a)
    k = key_a.shape[0]
    args = [_b.byte_ptr(NAME, n, t, dev) for n, t in (
        ("key_a", key_a), ("pay_a", pay_a), ("key_b", key_b),
        ("pay_b", pay_b), ("key_o", key_o), ("pay_o", pay_o))]
    row_bytes = pay_a[0].numel() * pay_a.element_size() if k else 0
    lib = _b.load(NAME, _ARGTYPES)
    with torch.cuda.device(dev):
        status = lib.lww_merge(*args, k, row_bytes, _b.stream(dev))
    launches += 1
    _b.raise_on_error(NAME, lib, status)
    return key_o, pay_o
