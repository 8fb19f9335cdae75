"""Hopper kernel: the LWW-guarded scatter of a delta buffer into a register
bank (lane j writes register ``d_idx[j]`` where its key beats the bank's).

Replaces ``src/repro/kernels/delta_apply.py`` · ``delta_apply``; the CUDA
source and its design notes are in ``csrc/delta_apply.cu``.  Callers go
through ``ops.delta_apply``, which checks the contract, casts the lanes'
payload to the bank's dtype and sends CPU tensors to ``ref``.  Duplicate
targets resolve as ``ref.delta_apply`` says (largest key, then lowest
lane); nothing is padded to the TPU's tiles.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as _b

NAME = "delta_apply"
_LL = ctypes.c_longlong
_ARGTYPES = [_b.PTR] * 7 + [_b.INT, _b.INT, _LL, _b.PTR]

launches = 0            # kernel launches through this wrapper


def delta_apply(key: torch.Tensor, pay: torch.Tensor, d_idx: torch.Tensor,
                d_key: torch.Tensor, d_pay: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """key: int32 [K]; pay: [K, ...]; d_idx, d_key: int32 [Dc]; d_pay:
    [Dc, ...] in pay's dtype and row shape; all contiguous on one card,
    K < 2^31.  Returns new (key, pay)."""
    global launches
    dev = key.device
    key_o = torch.empty_like(key)
    pay_o = torch.empty_like(pay)
    k, dc = key.shape[0], d_idx.shape[0]
    args = [_b.byte_ptr(NAME, n, t, dev) for n, t in (
        ("key", key), ("pay", pay), ("d_idx", d_idx), ("d_key", d_key),
        ("d_pay", d_pay), ("key_o", key_o), ("pay_o", pay_o))]
    row_bytes = pay[0].numel() * pay.element_size() if k else 0
    lib = _b.load(NAME, _ARGTYPES)
    with torch.cuda.device(dev):
        status = lib.delta_apply(*args, k, dc, row_bytes, _b.stream(dev))
    launches += 1
    _b.raise_on_error(NAME, lib, status)
    return key_o, pay_o
