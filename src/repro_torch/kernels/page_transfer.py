"""Hopper kernel: the cross-pool page-row transfer of disaggregated
adoption, ``dst_pool[dst_ids[i]] = src_pool[src_ids[i]]``.

Replaces ``src/repro/kernels/page_transfer.py`` · ``page_transfer``; the
CUDA source and its design notes are in ``csrc/page_transfer.cu``.
Callers go through ``ops.page_transfer``, which checks the contract and
sends CPU tensors to ``ref``.  Rows are moved as bytes, so every dtype
takes the same kernel; the kernel picks 16-, 4- or 1-byte accesses from
the pools' alignment and row size.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as _b

NAME = "page_transfer"
_LL = ctypes.c_longlong
_ARGTYPES = [_b.PTR] * 4 + [_b.INT, _LL, _LL, _LL, _b.PTR]

launches = 0            # kernel launches through this wrapper


def _check(name: str, t: torch.Tensor, dev: torch.device) -> None:
    if t.device != dev:
        raise ValueError(f"{NAME}: {name} is on {t.device}, not {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{NAME}: {name} must be contiguous")


def page_transfer(src_pool: torch.Tensor, dst_pool: torch.Tensor,
                  src_ids: torch.Tensor, dst_ids: torch.Tensor
                  ) -> torch.Tensor:
    """src_pool [Ps, ...row], dst_pool [Pd, ...row] (same row shape and
    dtype, distinct storage); src_ids, dst_ids int32 [N] on the pools'
    device.  Updates ``dst_pool`` in place and returns it."""
    global launches
    dev = dst_pool.device
    for name, t in (("src_pool", src_pool), ("dst_pool", dst_pool),
                    ("src_ids", src_ids), ("dst_ids", dst_ids)):
        _check(name, t, dev)
    for name, t in (("src_ids", src_ids), ("dst_ids", dst_ids)):
        if t.dtype != torch.int32 or t.shape != src_ids.shape:
            raise ValueError(f"{NAME}: {name} must be int32 "
                             f"{tuple(src_ids.shape)}")
    n = src_ids.shape[0]
    row_bytes = dst_pool[0].numel() * dst_pool.element_size() \
        if dst_pool.shape[0] else 0
    lib = _b.load(NAME, _ARGTYPES)
    with torch.cuda.device(dev):
        status = lib.page_transfer(
            ctypes.c_void_p(src_pool.data_ptr()),
            ctypes.c_void_p(dst_pool.data_ptr()),
            ctypes.c_void_p(src_ids.data_ptr()),
            ctypes.c_void_p(dst_ids.data_ptr()), n, src_pool.shape[0],
            dst_pool.shape[0], row_bytes, _b.stream(dev))
    launches += 1
    _b.raise_on_error(NAME, lib, status)
    return dst_pool
