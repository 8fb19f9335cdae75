"""Where a block of the MHA tensor-core walk spends its cycles in the
decode form (``attend_mma::chunk_mma`` at span 1, as ``paged_decode_
attention`` and ``_quant`` launch it), on one CUDA card.

  python src/repro_torch/benchmarks/walk_clock.py [--iters N]

The production kernels carry no timers.  This script copies
``kernels/csrc/*.cuh`` into a temporary directory, inserts ``clock64()``
reads at the walk's phase boundaries in the copy of ``attend_mma.cuh``
(thread 0 of each block adds each phase's cycles to a device counter),
builds it with nvcc beside a small C entry point, and runs the walk alone
(no token write) at the kernel phase's decode shape (8 rows at the
positions of ``chip_smoke.py``, OLMo-1B's 16 heads of 128, page 16,
max_len 1024), on bf16 and int8 pools, with the key split the wrappers
take (``paged_chunk_attention_quant.decode_split_plan``).  Phases:

  setup   block start to the tile loop: q copies and the ring's first
          NST - 1 gathers issued
  wait    each tile: cp.async wait for the tile and the barrier after it
  convert each tile (codes only): the tile to bf16 and its barrier
  mma     each tile: S = Q K^T, the online softmax, O += P V and the
          barrier that frees the ring slot
  merge   after the walk: the warps' key parts merged, the partial (or
          out) written
  block   a block's whole time (every block); ``empty`` the blocks of
          splits with no key (past pos), which write an empty partial and
          end

One JSON line a pool: cycles a block and a tile per phase, the counts,
then the card's name and power limit.  The anchors the copy is patched at
are checked: a change to the walk that moves them fails here loudly.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parents[2]
PHASES = ("setup", "wait", "convert", "mma", "merge", "block", "empty")
POS = [1023, 17, 300, 511, 640, 5, 999, 128]
B, H, D, PS, MAX_LEN = 8, 16, 128, 16, 1024

TICK = ("if (tid == 0) {{ const long long am_n = clock64(); "
        "atomicAdd(&am_clk[{i}], (unsigned long long)(am_n - am_t)); "
        "atomicAdd(&am_cnt[{i}], 1ull); am_t = am_n; }}\n")
# (anchor in attend_mma.cuh, text inserted after it)
PATCHES = [
    ("namespace attend_mma {\n",
     "__device__ unsigned long long am_clk[8], am_cnt[8];\n"),
    ("  for (int m0 = 0; m0 < live; m0 += BR) {\n",
     "    long long am_t = clock64();\n"),
    ("      continue;\n    }\n", ""),     # checked only (the empty split)
    ("    const int mw = m0 + wt * 16;           // this warp's first row\n",
     TICK.format(i=0)),
    ("      tc::cp_async_wait<NST - 1>();        // tile it has landed\n"
     "      __syncthreads();\n", TICK.format(i=1)),
    ("        kv = cv;\n      }\n", TICK.format(i=2)),
    ("      __syncthreads();                     // the ring slot is free "
     "again\n", TICK.format(i=3)),
    ("    tc::cp_async_wait<0>();                // (the trailing empty "
     "groups)\n", TICK.format(i=4)),
]
# The empty split's early end and the block's end: counted from the
# kernel's start.
EMPTY = ("      continue;\n    }\n",
         "      if (tid == 0) { atomicAdd(&am_clk[6], (unsigned long long)"
         "(clock64() - am_t0)); atomicAdd(&am_cnt[6], 1ull); }\n"
         "      continue;\n    }\n")
START = ("  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n",
         "  const long long am_t0 = clock64();\n")
END = ("    __syncthreads();                       // the raw ring and q "
       "terms are\n                                           // rebuilt "
       "next pass\n  }\n",
       "  if (tid == 0) { atomicAdd(&am_clk[5], (unsigned long long)"
       "(clock64() - am_t0)); atomicAdd(&am_cnt[5], 1ull); }\n")

ENTRY = r"""
#include "attend_mma.cuh"
extern "C" int walk(int pool, const void* q, void* out, const void* kp,
                    const void* vp, const float* ks, const float* vs,
                    const int* bt, const int* pos, float* part, int b,
                    int hq, int hkv, int d, int ps, int maxp, float scale,
                    int nsplit, int split_len) {
  using namespace attend_mma;
  if (pool == 0)
    return attend<__nv_bfloat16, Bf16Pool>(q, out, kp, vp, ks, vs, bt, pos,
        nullptr, part, b, hq, hkv, 1, d, ps, maxp, scale, 0, nsplit,
        split_len, 0);
  return attend<__nv_bfloat16, CodePool<rt::Int8Codec>>(q, out, kp, vp, ks,
      vs, bt, pos, nullptr, part, b, hq, hkv, 1, d, ps, maxp, scale, 0,
      nsplit, split_len, 0);
}
extern "C" int clocks(unsigned long long* dst, int reset) {
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(dst, attend_mma::am_clk, sizeof(attend_mma::am_clk));
  cudaMemcpyFromSymbol(dst + 8, attend_mma::am_cnt,
                       sizeof(attend_mma::am_cnt));
  if (reset) {
    unsigned long long z[8] = {};
    cudaMemcpyToSymbol(attend_mma::am_clk, z, sizeof(z));
    cudaMemcpyToSymbol(attend_mma::am_cnt, z, sizeof(z));
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def patched_copy(dst: Path) -> None:
    """The csrc headers in ``dst``, attend_mma.cuh with the timers."""
    csrc = SRC / "repro_torch" / "kernels" / "csrc"
    for h in csrc.glob("*.cuh"):
        shutil.copy(h, dst / h.name)
    text = (csrc / "attend_mma.cuh").read_text()
    for anchor, add in [*PATCHES, START]:
        if text.count(anchor) != 1:
            raise RuntimeError(f"walk_clock: anchor not found once: {anchor!r}")
    for anchor, add in PATCHES:
        if add:
            text = text.replace(anchor, anchor + add)
    text = text.replace(START[0], START[0] + START[1])
    text = text.replace(EMPTY[0], EMPTY[1])
    if text.count(END[0]) != 1:
        raise RuntimeError("walk_clock: the walk's end not found once")
    text = text.replace(END[0], END[0] + END[1])
    (dst / "attend_mma.cuh").write_text(text)
    (dst / "walk_clock.cu").write_text(ENTRY)


def build(dst: Path) -> ctypes.CDLL:
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build as kbuild
    lib = dst / "libwalk_clock.so"
    subprocess.run([kbuild.nvcc(), *kbuild.FLAGS, "-o", str(lib),
                    str(dst / "walk_clock.cu")], check=True,
                   capture_output=True)
    so = ctypes.CDLL(str(lib))
    so.walk.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                        + [ctypes.c_int] * 6 + [ctypes.c_float]
                        + [ctypes.c_int] * 2)
    so.clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return so


def run(so, pool: str, iters: int) -> dict:
    from repro_torch.kernels import paged_chunk_attention_quant as kq
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import sm_count
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    maxp = MAX_LEN // PS
    pages = B * maxp + 1
    bt = torch.as_tensor(np.random.default_rng(7).permutation(B * maxp)
                         .reshape(B, maxp).astype(np.int32), device=dev)
    pos = torch.as_tensor(POS, dtype=torch.int32, device=dev)
    q = torch.randn((B, H, D), generator=gen, device=dev).bfloat16()
    rows = [torch.randn((pages, H, PS, D), generator=gen, device=dev)
            for _ in range(2)]
    if pool == "bf16":
        kp, vp = (x.bfloat16() for x in rows)
        ks = vs = None
    else:
        (kp, ks), (vp, vs) = (ref.quantize_rows(x, torch.int8) for x in rows)
    plan = kq.decode_split_plan(B, H, MAX_LEN, sm_count(0))
    out = torch.empty_like(q)
    part = torch.empty(plan.blocks * (D + 2), dtype=torch.float32,
                       device=dev)

    def call():
        status = so.walk(0 if pool == "bf16" else 1, q.data_ptr(),
                         out.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                         None if ks is None else ks.data_ptr(),
                         None if vs is None else vs.data_ptr(),
                         bt.data_ptr(), pos.data_ptr(), part.data_ptr(), B,
                         H, H, D, PS, maxp, D ** -0.5, plan.nsplit,
                         plan.split_len)
        if status:
            raise RuntimeError(f"walk_clock: CUDA status {status}")
    buf = (ctypes.c_ulonglong * 16)()
    call()
    so.clocks(buf, 1)
    for _ in range(iters):
        call()
    so.clocks(buf, 1)
    clk, cnt = list(buf[:8]), list(buf[8:])
    walked = cnt[5] - cnt[6]              # blocks with a key to walk
    got = {"pool": pool, "plan": plan._asdict(), "iters": iters,
           "blocks_a_call": cnt[5] / iters,
           "empty_blocks_a_call": cnt[6] / iters,
           "tiles_a_call": cnt[1] / iters}
    for i, name in enumerate(PHASES):
        if cnt[i]:
            got[f"{name}_cycles_each"] = clk[i] / cnt[i]
    if walked:
        for i, name in enumerate(PHASES[:5]):
            got[f"{name}_cycles_a_walking_block"] = clk[i] / walked
        got["walking_block_cycles"] = (clk[5] - clk[6]) / walked
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("walk_clock: no CUDA card is present", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        patched_copy(Path(tmp))
        so = build(Path(tmp))
        for pool in ("bf16", "int8"):
            print(json.dumps(run(so, pool, args.iters)), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
