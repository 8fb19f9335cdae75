"""Hopper kernel: single-query attention over a dense KV cache with a
per-row valid length (GQA, no window).

Replaces ``src/repro/kernels/decode_attention.py`` · ``decode_attention``;
the CUDA source and its design notes are in ``csrc/decode_attention.cu``.
Callers go through ``ops.decode_attention``, which sends CPU tensors to
``ref``.  Unlike the TPU wrapper, nothing is padded: each row's walk stops
at its ``kv_len``.

The keys are split over blocks (split-KV) by ``split_plan``, which reads
shapes only: ``kv_len`` lives on the card, and reading it on the host would
synchronise every decode step.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build as _b

NAME = "decode_attention"
_ARGTYPES = ([_b.INT] + [_b.PTR] * 7 + [_b.INT] * 7
             + [_b.FLOAT, _b.PTR])

MAX_SPLITS = 256         # the combine keeps a weight a split in shared memory
MIN_SPLIT_LEN = 16       # keys a split takes at least
MAX_SPLIT_LEN = 128      # and at most, while MAX_SPLITS allows
BLOCKS_PER_SM = 4        # the plan aims at this many blocks an SM

launches = 0            # wrapper calls that launched the kernels


class SplitPlan(NamedTuple):
    nsplit: int         # key ranges a query row is split into
    split_len: int      # keys a range: [i·split_len, (i+1)·split_len)
    blocks: int         # blocks of the first launch
    target: int         # the blocks the plan aims at


@functools.lru_cache(maxsize=256)
def split_plan(b: int, hq: int, s: int, d: int, sms: int) -> SplitPlan:
    """The split of the keys [0, s) over blocks, from shapes alone.

    A block takes one query row (b, query head) over ``split_len`` keys of
    its KV head; the heads of a GQA group read the same keys, the second
    and later from L2 (csrc/decode_attention.cu says why).  The plan aims
    at ``BLOCKS_PER_SM`` blocks on each of ``sms`` SMs where s allows
    it: a split holds at least ``max(MIN_SPLIT_LEN, keys a block reads at
    once)`` keys (128 threads, one 16-byte bf16 load a lane of a key row of
    ``d``) and at most ``MAX_SPLIT_LEN`` (a block's walk stays a few load
    latencies long), and there are at most ``MAX_SPLITS``.  The ranges
    cover [0, s) with no gap and no overlap, the last one cut at s.
    """
    heads = b * hq
    min_len = max(MIN_SPLIT_LEN, 128 // max(1, min(32, d // 8)))
    want = max(1, -(-BLOCKS_PER_SM * sms // max(heads, 1)))
    split_len = max(min_len, min(s // want, MAX_SPLIT_LEN),
                    -(-s // MAX_SPLITS))
    nsplit = max(1, -(-s // split_len))
    target = heads * min(want, max(1, -(-s // min_len)), MAX_SPLITS)
    return SplitPlan(nsplit, split_len, heads * nsplit, target)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor, *, scale: float) -> torch.Tensor:
    """q: [B, Hq, D]; k, v: [B, Hkv, S, D] (q's dtype); kv_len: i32[B].
    Returns out [B, Hq, D] (zero for rows with kv_len 0)."""
    global launches
    b, hq, d = q.shape
    _, hkv, s, _ = k.shape
    dev = q.device
    code = _b.check_dims(NAME, q.dtype, d, _b.HEAD_DIMS_256)
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
    plan = split_plan(b, hq, s, d, sm_count(dev.index or 0))
    if plan.nsplit > 1:
        # One allocation: part_acc [B, Hq, nsplit, D], then part_ml [B, Hq,
        # nsplit, 2] (float32; D a multiple of 16 keeps it 16-byte aligned).
        n_acc = b * hq * plan.nsplit * d
        part = torch.empty(n_acc + b * hq * plan.nsplit * 2,
                           dtype=torch.float32, device=dev)
        args += [_b.PTR(part.data_ptr()), _b.PTR(part.data_ptr() + 4 * n_acc)]
    else:
        args += [_b.PTR(None), _b.PTR(None)]
    lib = _b.load(NAME, _ARGTYPES)
    with torch.cuda.device(dev):
        status = lib.decode_attention(code, *args, b, hq, hkv, s, d,
                                      plan.nsplit, plan.split_len, scale,
                                      _b.stream(dev))
    launches += 1
    _b.raise_on_error(NAME, lib, status)
    return out
