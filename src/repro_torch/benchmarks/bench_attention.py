"""Times ``flash_attention`` and ``decode_attention`` at the shapes of the
port's main paths, on one CUDA card, against SDPA, and the tensor-core
walks of the paged kernels (``paged_chunk_attention`` and
``paged_mla_chunk`` on bf16 pools, their ``_quant`` twins on int8 / fp8
pools, the MLA decode kernels ``paged_mla_decode`` and ``_quant``, and
the MHA decode kernels ``paged_decode_attention`` and ``_quant``) through
``ops``, as the models call them.

  python src/repro_torch/benchmarks/bench_attention.py [--src DIR]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (by
default the tree this file lives in), so one call can time two trees in
turns (parent, change, change, parent) on the same card.  Each line of
output is one JSON object: the kernel, its shape, the tree, the
kernel's time by CUDA events around the wrapper (``ms``) and by the
profiler's device time (``device_ms``: the kernels whose name holds
``flash_fwd`` / ``dense_attend``; ``device_us_by_kernel`` splits it by
kernel), SDPA's two times (``library_ms``,
``library_device_ms``: every kernel of the call), and the largest
difference from the plain version (``max_abs_err``).  The last line names
the card and its power limit.  Without a card it exits with code 2.

Shapes: whisper-tiny's encoder (q/k/v [8, 6, 1500, 64] bf16,
bidirectional); ``decode_attention`` at OLMo-1B's dense ``Engine`` (q [8,
16, 128], k/v [8, 16, 1024, 128]), RecurrentGemma-2B's local attention
(q [8, 10, 256], k/v [8, 1, 1024, 256]) and whisper-tiny's decoder (q [8,
6, 64], k/v [8, 6, 256, 64]), bf16, ragged kv_len.  The quantized chunk
walks (int8 and fp8 pools with f32 row scales, page 16, max_len 1024): at
``chip_smoke.py``'s kernel phase (8 rows, chunk 64, start / span as there;
OLMo-1B's q [8, 16, 64, 128] bf16, DeepSeek-V2-Lite's 16 heads over a
512 + 64 latent row in pool rows of 640) and at the agent trials' (4 rows,
chunk 32: ``decode`` all span 1, ``mixed`` three span-1 rows and a 32-token
prompt chunk).  The bf16 walks at the kernel phase and at a decode step
of the OLMo-1B / MLA schedulers (``sched_decode``: 8 rows of span 1 in a
64-wide chunk at ragged starts), bf16 pools (the MLA one [P, 16, 640]).
The MLA decode kernels (bf16 pool; int8 and fp8 pools with f32 row
scales) at the kernel phase's 8 positions, at the paged MLA ``Engine``'s
decode step (8 rows at pos 136: 128 prompt tokens, mid-run) and at the
agent trial's 4-row decode step.  Their ``device_ms`` sums every kernel
of the call (the write, the walk, a combine), there is no library call,
and ``max_abs_err`` is against the plain version at the defined
positions.  The decode rows pass the model's bf16 q_rope, which the
kernels read in place.  The MHA decode kernels (bf16 pools; int8 and fp8
pools with f32 row scales; OLMo-1B's q [B, 16, 128] bf16, pools [P, 16,
16, 128]) at the same three shapes (``engine_decode``: the paged OLMo-1B
``Engine``'s step), ``device_ms`` again every kernel of the call.
"""
from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

LENS_1024 = [1024, 18, 301, 512, 641, 6, 1000, 129]
LENS_256 = [256, 33, 1, 200, 129, 84, 255, 17]
DECODE = {   # name: (B, Hq, Hkv, S, D, kv_len)
    "decode_attention_d128": (8, 16, 16, 1024, 128, LENS_1024),
    "decode_attention_d256": (8, 10, 1, 1024, 256, LENS_1024),
    "decode_attention_d64": (8, 6, 6, 256, 64, LENS_256),
}


def events_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


@functools.lru_cache(maxsize=1)
def _kernel_trace():
    """``launch/device_trace.kernel_trace`` of this file's tree, loaded by
    path: the tree ``--src`` names may predate it."""
    path = Path(__file__).resolve().parents[1] / "launch" / "device_trace.py"
    spec = importlib.util.spec_from_file_location("_bench_device_trace", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.kernel_trace


def device_us(fn, iters: int = 20) -> dict[str, float]:
    """Mean device time in µs a call of ``fn`` by CUDA kernel name, from a
    torch.profiler trace whose counted launches all have their kernel
    records (``device_trace.kernel_trace``: else taken again)."""
    got = _kernel_trace()(fn, iters)
    if not got:
        raise RuntimeError("the profiler saw no kernel")
    return got


def _short(name: str) -> str:
    """A kernel's name without ``void``, its namespace and its arguments:
    ``void (anonymous namespace)::f<int, 64>(int*)`` -> ``f<int, 64>``."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0]


def _row(name, shape, tree, fn, plain, lib, match) -> dict:
    got, want = fn(), plain()
    live = ~torch.isnan(want.float())
    err = float((got.float() - want.float())[live].abs().max())
    kern = {k: us for k, us in device_us(fn).items() if match in k}
    return dict(kernel=name, shape=shape, tree=tree, max_abs_err=err,
                ms=events_ms(fn), device_ms=sum(kern.values()) / 1e3,
                device_us_by_kernel={_short(k): us for k, us in kern.items()},
                library_ms=events_ms(lib),
                library_device_ms=sum(device_us(lib).values()) / 1e3)


# The quantized chunk walks: (rows, chunk, start, span) of each shape.
PS, MAX_LEN = 16, 1024
QUANT_SHAPES = {
    "kernel_phase": (8, 64, [0, 100, 300, 447, 700, 900, 959, 64],
                     [64, 64, 1, 1, 0, 30, 64, 17]),
    "trial_decode": (4, 32, [412, 590, 733, 96], [1, 1, 1, 1]),
    "trial_mixed": (4, 32, [412, 590, 733, 96], [1, 1, 1, 32]),
}
# The shapes of every walk row; the bf16 walks take the kernel phase and a
# decode step of the schedulers.
WALK_SHAPES = {**QUANT_SHAPES,
               "sched_decode": (8, 64, [412, 590, 733, 96, 1000, 17, 300,
                                        640], [1] * 8)}
BF16_SHAPES = ("kernel_phase", "sched_decode")
MLA_R, MLA_RD, MLA_DP = 512, 64, 640


def _table(b, start, span, dev):
    """[b, MAX_LEN / PS] pages drawn from a seeded permutation, the
    unallocated slots on the trash page (the last), row 1's tail at -1."""
    maxp = MAX_LEN // PS
    perm = np.random.default_rng(3).permutation(b * maxp)
    bt = np.full((b, maxp), b * maxp, np.int32)
    used = 0
    for i, n in enumerate(np.add(start, span)):
        k = -(-int(n) // PS)
        bt[i, :k] = perm[used:used + k]
        used += k
    bt[1, -(-int(start[1] + span[1]) // PS):] = -1
    return torch.as_tensor(bt, device=dev)


def _quant_rows(tree, gen, dev):
    """JSON rows of the two quantized chunk walks at QUANT_SHAPES."""
    from repro_torch.kernels import ops, ref
    for shape, (b, c, start, span) in QUANT_SHAPES.items():
        st = torch.as_tensor(start, dtype=torch.int32, device=dev)
        sp = torch.as_tensor(span, dtype=torch.int32, device=dev)
        bt = _table(b, start, span, dev)
        pages = b * (MAX_LEN // PS) + 1
        live = (torch.arange(c, device=dev)[None, :]
                < sp[:, None])[:, None, :, None]
        for qname, qdtype in (("int8", torch.int8),
                              ("fp8", torch.float8_e4m3fn)):
            def rand(*shape):
                return torch.randn(shape, generator=gen, device=dev)
            # OLMo-1B's MHA walk, bf16 q and new rows.
            q = rand(b, 16, c, 128).bfloat16()
            kn, vn = (rand(b, 16, c, 128).bfloat16() for _ in range(2))
            pools = [*ref.quantize_rows(rand(pages, 16, PS, 128), qdtype),
                     *ref.quantize_rows(rand(pages, 16, PS, 128), qdtype)]
            twin = [t.clone() for t in pools]
            def mha(impl="kernel", pools=pools):
                return ops.paged_chunk_attention_quant(
                    q, *pools, bt, st, sp, kn, vn, scale=128 ** -0.5,
                    impl=impl)[0]
            yield _walk_row("paged_chunk_attention_quant", shape, qname,
                            f"q[{b},16,{c},128] bf16, pools[{pages},16,"
                            f"{PS},128], start/span {start} {span}", tree,
                            mha, lambda: mha("ref", twin), live)
            # DeepSeek-V2-Lite's MLA walk, float32 q, bf16 new rows.
            q_abs, q_rope = rand(b, 16, c, MLA_R), rand(b, 16, c, MLA_RD)
            new = rand(b, c, MLA_DP).bfloat16()
            new[..., MLA_R + MLA_RD:] = 0
            lat = list(ref.quantize_rows(rand(pages, PS, MLA_DP), qdtype))
            ltwin = [t.clone() for t in lat]
            def mla(impl="kernel", lat=lat):
                return ops.paged_mla_chunk_quant(
                    q_abs, q_rope, *lat, bt, st, sp, new,
                    scale=(128 + MLA_RD) ** -0.5, impl=impl)[0]
            yield _walk_row("paged_mla_chunk_quant", shape, qname,
                            f"q_abs[{b},16,{c},{MLA_R}] + q_rope f32, pool"
                            f"[{pages},{PS},{MLA_DP}], start/span {start} "
                            f"{span}", tree, mla,
                            lambda: mla("ref", ltwin), live)


def _bf16_rows(tree, gen, dev):
    """JSON rows of the two bf16-pool chunk walks at BF16_SHAPES."""
    from repro_torch.kernels import ops
    for shape in BF16_SHAPES:
        b, c, start, span = WALK_SHAPES[shape]
        st = torch.as_tensor(start, dtype=torch.int32, device=dev)
        sp = torch.as_tensor(span, dtype=torch.int32, device=dev)
        bt = _table(b, start, span, dev)
        pages = b * (MAX_LEN // PS) + 1
        live = (torch.arange(c, device=dev)[None, :]
                < sp[:, None])[:, None, :, None]

        def rand(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        q = rand(b, 16, c, 128).bfloat16()
        kn, vn = (rand(b, 16, c, 128).bfloat16() for _ in range(2))
        pools = [rand(pages, 16, PS, 128).bfloat16() for _ in range(2)]
        twin = [t.clone() for t in pools]

        def mha(impl="kernel", pools=pools):
            return ops.paged_chunk_attention(
                q, *pools, bt, st, sp, kn, vn, scale=128 ** -0.5,
                impl=impl)[0]
        yield _walk_row("paged_chunk_attention", shape, "bf16",
                        f"q[{b},16,{c},128] bf16, pools[{pages},16,{PS},128]"
                        f", start/span {start} {span}", tree, mha,
                        lambda: mha("ref", twin), live)
        q_abs, q_rope = rand(b, 16, c, MLA_R), rand(b, 16, c, MLA_RD)
        new = rand(b, c, MLA_DP).bfloat16()
        new[..., MLA_R + MLA_RD:] = 0
        lat = [rand(pages, PS, MLA_DP).bfloat16()]
        ltwin = [lat[0].clone()]

        def mla(impl="kernel", lat=lat):
            return ops.paged_mla_chunk(
                q_abs, q_rope, *lat, bt, st, sp, new,
                scale=(128 + MLA_RD) ** -0.5, impl=impl)[0]
        yield _walk_row("paged_mla_chunk", shape, "bf16",
                        f"q_abs[{b},16,{c},{MLA_R}] + q_rope f32, pool"
                        f"[{pages},{PS},{MLA_DP}], start/span {start} "
                        f"{span}", tree, mla, lambda: mla("ref", ltwin),
                        live)


# The decode kernels (MLA and MHA): (rows, pos) of each shape.
DECODE_SHAPES = {
    "kernel_phase": (8, [1023, 17, 300, 511, 640, 5, 999, 128]),
    "engine_decode": (8, [136] * 8),
    "trial_decode": (4, [412, 590, 733, 96]),
}


def _mla_decode_rows(tree, gen, dev):
    """JSON rows of paged_mla_decode (bf16 pool) and paged_mla_decode_quant
    (int8, fp8) at DECODE_SHAPES, q_rope bf16 (the model's)."""
    from repro_torch.kernels import ops, ref
    for shape, (b, pos) in DECODE_SHAPES.items():
        pt = torch.as_tensor(pos, dtype=torch.int32, device=dev)
        bt = _table(b, pos, [1] * b, dev)
        pages = b * (MAX_LEN // PS) + 1
        live = torch.ones((), dtype=torch.bool, device=dev)

        def rand(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        q_abs = rand(b, 16, MLA_R)
        q_rope = rand(b, 16, MLA_RD).bfloat16()
        new = rand(b, MLA_DP).bfloat16()
        new[..., MLA_R + MLA_RD:] = 0
        detail = (f"q_abs[{b},16,{MLA_R}] f32 + q_rope bf16, pool[{pages},"
                  f"{PS},{MLA_DP}], pos {pos}")
        scale = (128 + MLA_RD) ** -0.5
        for qname, qdtype in (("bf16", torch.bfloat16),
                              ("int8", torch.int8),
                              ("fp8", torch.float8_e4m3fn)):
            rows = rand(pages, PS, MLA_DP)
            lat = ([rows.bfloat16()] if qname == "bf16"
                   else list(ref.quantize_rows(rows, qdtype)))
            twin = [t.clone() for t in lat]
            name = ("paged_mla_decode" if qname == "bf16"
                    else "paged_mla_decode_quant")
            op = getattr(ops, name)

            def mla(impl="kernel", lat=lat, op=op):
                return op(q_abs, q_rope, *lat, bt, pt, new, scale=scale,
                          impl=impl)[0]
            yield _walk_row(name, shape, qname, detail, tree, mla,
                            lambda: mla("ref", twin), live)


def _mha_decode_rows(tree, gen, dev):
    """JSON rows of paged_decode_attention (bf16 pools) and
    paged_decode_attention_quant (int8, fp8) at DECODE_SHAPES, bf16 q and
    new rows (OLMo-1B's)."""
    from repro_torch.kernels import ops, ref
    for shape, (b, pos) in DECODE_SHAPES.items():
        pt = torch.as_tensor(pos, dtype=torch.int32, device=dev)
        bt = _table(b, pos, [1] * b, dev)
        pages = b * (MAX_LEN // PS) + 1
        live = torch.ones((), dtype=torch.bool, device=dev)

        def rand(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        q = rand(b, 16, 128).bfloat16()
        kn, vn = (rand(b, 16, 128).bfloat16() for _ in range(2))
        detail = (f"q[{b},16,128] bf16, pools[{pages},16,{PS},128], "
                  f"pos {pos}")
        for qname, qdtype in (("bf16", torch.bfloat16),
                              ("int8", torch.int8),
                              ("fp8", torch.float8_e4m3fn)):
            rows = [rand(pages, 16, PS, 128) for _ in range(2)]
            if qname == "bf16":
                pools = [x.bfloat16() for x in rows]
                name = "paged_decode_attention"
            else:
                pools = [*ref.quantize_rows(rows[0], qdtype),
                         *ref.quantize_rows(rows[1], qdtype)]
                name = "paged_decode_attention_quant"
            twin = [t.clone() for t in pools]
            op = getattr(ops, name)

            def mha(impl="kernel", pools=pools, op=op):
                return op(q, *pools, bt, pt, kn, vn, scale=128 ** -0.5,
                          impl=impl)[0]
            yield _walk_row(name, shape, qname, detail, tree, mha,
                            lambda: mha("ref", twin), live)


def _walk_row(name, shape, qname, shapes, tree, fn, plain, live) -> dict:
    """The JSON row of one walk call."""
    got, want = fn(), plain()
    err = float(torch.where(live, got.float() - want.float(), 0)
                .abs().max())
    kern = device_us(fn)
    return dict(kernel=name, shape=shape, pool=qname, shapes=shapes,
                tree=tree, max_abs_err=err, ms=events_ms(fn),
                device_ms=sum(kern.values()) / 1e3,
                device_us_by_kernel={_short(k): us for k, us in kern.items()},
                library_ms=None, library_device_ms=None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_attention: no CUDA card is present", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.kernels import decode_attention as kdec
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    q, k, v = (rand(8, 6, 1500, 64) for _ in range(3))
    scale = 64 ** -0.5
    print(json.dumps(_row(
        "flash_attention", "q/k/v[8,6,1500,64] bf16, bidirectional",
        args.src,
        lambda: kflash.flash_attention(q, k, v, causal=False, scale=scale,
                                       window=None),
        lambda: ref.flash_attention(q, k, v, causal=False, scale=scale),
        lambda: sdpa(q, k, v, scale=scale), "flash_fwd")), flush=True)
    for name, (b, hq, hkv, s, d, lens) in DECODE.items():
        q, k, v = rand(b, hq, d), rand(b, hkv, s, d), rand(b, hkv, s, d)
        kl = torch.as_tensor(np.array(lens), dtype=torch.int32, device=dev)
        mask = (torch.arange(s, device=dev)[None, :]
                < kl[:, None])[:, None, None, :]
        kx, vx = k.expand(-1, hq, -1, -1), v.expand(-1, hq, -1, -1)
        scale = d ** -0.5
        print(json.dumps(_row(
            name, f"q[{b},{hq},{d}] k/v[{b},{hkv},{s},{d}] bf16, kv_len "
                  f"{lens}", args.src,
            lambda: kdec.decode_attention(q, k, v, kl, scale=scale),
            lambda: ref.decode_attention(q, k, v, kl, scale=scale),
            lambda: sdpa(q[:, :, None], kx, vx, attn_mask=mask,
                         scale=scale)[:, :, 0], "dense_attend")), flush=True)
    for rows in (_quant_rows, _bf16_rows, _mla_decode_rows,
                 _mha_decode_rows):
        for row in rows(args.src, gen, dev):
            print(json.dumps(row), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
