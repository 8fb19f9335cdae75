"""Hopper kernel: the cross-pool page-row transfer of disaggregated
adoption, ``dst_pool[dst_ids[i]] = src_pool[src_ids[i]]``, for a table of
pool pairs ("leaves") in one launch.

Replaces ``src/repro/kernels/page_transfer.py`` · ``page_transfer``; the
CUDA source and its design notes are in ``csrc/page_transfer.cu``.
Callers go through ``ops.page_transfer`` (one pair) or
``ops.page_transfer_leaves`` (every pool leaf of an adoption), which check
the contract, send CPU tensors to ``ref`` and call
``page_transfer_leaves`` here.  Rows are moved as bytes, so every dtype
takes the same kernel; ``leaf_tables`` picks each leaf's 16-, 4- or
1-byte accesses from its pools' alignment and row size, and cuts a table
past ``MAX_LEAVES`` into one launch a chunk.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build as _b

NAME = "page_transfer"
MAX_LEAVES = 64         # descriptors a launch: the parameters stay < 4 KB
_ARGTYPES = [_b.PTR, _b.INT, _b.PTR, _b.PTR, _b.INT, _b.PTR]

launches = 0            # kernel launches through this wrapper


class Leaf(ctypes.Structure):
    """One leaf's descriptor, laid out as ``Leaf`` in the CUDA source
    (whose last field, the slices a row, the C entry point sets)."""
    _fields_ = [("src", ctypes.c_void_p), ("dst", ctypes.c_void_p),
                ("row_bytes", ctypes.c_longlong),
                ("num_src", ctypes.c_longlong),
                ("num_dst", ctypes.c_longlong),
                ("width", ctypes.c_int)]


def access_width(src_ptr: int, dst_ptr: int, row_bytes: int) -> int:
    """The widest access (16, 4 or 1 byte) both base pointers and the row
    size are aligned to: then every row, and every access in it, is."""
    bits = src_ptr | dst_ptr | row_bytes
    return 16 if bits % 16 == 0 else 4 if bits % 4 == 0 else 1


def leaf_tables(pairs) -> list:
    """The launches' descriptor tables for ``pairs`` of (src_pool,
    dst_pool): ctypes arrays of at most ``MAX_LEAVES`` ``Leaf``s, in the
    pairs' order.  A pair with empty rows or an empty pool moves nothing
    and gets no descriptor."""
    leaves = []
    for src, dst in pairs:
        row_bytes = math.prod(dst.shape[1:]) * dst.element_size()
        if row_bytes == 0 or src.shape[0] == 0 or dst.shape[0] == 0:
            continue
        leaves.append(Leaf(src.data_ptr(), dst.data_ptr(), row_bytes,
                           src.shape[0], dst.shape[0],
                           access_width(src.data_ptr(), dst.data_ptr(),
                                        row_bytes)))
    return [(Leaf * len(chunk))(*chunk)
            for chunk in (leaves[i:i + MAX_LEAVES]
                          for i in range(0, len(leaves), MAX_LEAVES))]


def page_transfer_leaves(pairs, src_ids: torch.Tensor,
                         dst_ids: torch.Tensor) -> list[torch.Tensor]:
    """pairs: (src_pool [Ps, ...row], dst_pool [Pd, ...row]) of one row
    shape and dtype each, every destination apart from every other pool;
    src_ids, dst_ids: int32 [N] on the pools' device.  Updates every
    ``dst_pool`` in place with one launch a ``MAX_LEAVES`` chunk and
    returns them."""
    global launches
    dev = pairs[0][1].device
    for src, dst in pairs:
        _b.byte_ptr(NAME, "src_pool", src, dev)
        _b.byte_ptr(NAME, "dst_pool", dst, dev)
    ids = [_b.byte_ptr(NAME, name, t, dev)
           for name, t in (("src_ids", src_ids), ("dst_ids", dst_ids))]
    for name, t in (("src_ids", src_ids), ("dst_ids", dst_ids)):
        if t.dtype != torch.int32 or t.shape != src_ids.shape:
            raise ValueError(f"{NAME}: {name} must be int32 "
                             f"{tuple(src_ids.shape)}")
    lib = _b.load(NAME, _ARGTYPES)
    with torch.cuda.device(dev):
        for table in leaf_tables(pairs):
            status = lib.page_transfer(table, len(table), *ids,
                                       src_ids.shape[0], _b.stream(dev))
            launches += 1
            _b.raise_on_error(NAME, lib, status)
    return [dst for _, dst in pairs]

