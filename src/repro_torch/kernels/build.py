"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source ``csrc/<name>.cu`` compiles on its own into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/lib<name>-<digest>.so csrc/<name>.cu

The library name carries a digest of the sources and flags, so an edit
rebuilds and an unchanged tree reuses what ``_build/`` (git-ignored) holds.
Libraries are built at first use; ``build()`` starts one nvcc per source,
all together, for callers that want every kernel up front.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
SOURCES = ("decode_attention", "paged_decode_attention",
           "paged_chunk_attention", "paged_decode_attention_quant",
           "paged_chunk_attention_quant", "paged_mla_decode",
           "paged_mla_chunk", "paged_mla_decode_quant",
           "paged_mla_chunk_quant", "linear_scan")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin``, PATH, /usr/local/cuda."""
    cands = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
             shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (set CUDA_HOME)")


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every source in ``names`` not built yet, one nvcc each, all
    started together.  Returns {name: compiler log} for what was compiled
    (ptxas lists each kernel's registers and shared memory)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, out)          # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str, argtypes: list) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed, with
    the C function ``name`` declared: ``argtypes`` in, int status out."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            lib.rt_error_string.argtypes = [ctypes.c_int]
            lib.rt_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib


# -- binding helpers shared by the kernel wrappers ---------------------------

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
QUANT_CODES = {torch.int8: 0, torch.float8_e4m3fn: 1}
HEAD_DIMS = (16, 32, 64, 128)
# decode_attention also takes 256 (its tiles move to dynamic shared memory).
DENSE_HEAD_DIMS = HEAD_DIMS + (256,)
PTR, INT, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def ptr(kernel: str, name: str, t: torch.Tensor, device: torch.device, *,
        dtype=None, shape=None) -> ctypes.c_void_p:
    """Device pointer of ``t`` after checking what the kernel assumes:
    device, dtype, shape, contiguity and 16-byte alignment."""
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, not {device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{kernel}: {name} is {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{kernel}: {name} must be 16-byte aligned")
    return ctypes.c_void_p(t.data_ptr())


def dtype_code(kernel: str, dtype: torch.dtype) -> int:
    """The kernel's code for a float dtype; raises on others."""
    if dtype not in DTYPE_CODES:
        raise ValueError(f"{kernel}: dtype {dtype} is not supported "
                         f"(float32, bfloat16)")
    return DTYPE_CODES[dtype]


def check_dims(kernel: str, dtype: torch.dtype, head_dim: int,
               head_dims: tuple[int, ...] = HEAD_DIMS) -> int:
    """The kernel's dtype code; raises on a dtype or head_dim it lacks."""
    code = dtype_code(kernel, dtype)
    if head_dim not in head_dims:
        raise ValueError(f"{kernel}: head_dim {head_dim} is not supported "
                         f"{head_dims}")
    return code


MLA_MAX_R = 512        # value columns: at most 4 per thread of 128
MLA_MAX_L = 1024       # live latent width: q and key tiles in shared memory


def check_mla(kernel: str, q: torch.Tensor, latent_pages: torch.Tensor,
              r: int) -> tuple[int, int, int]:
    """(r, rd, Dp) of an MLA call; raises on what the kernels cannot take:
    q not float32, widths past the kernels' limits, or a pool row that is
    not whole 16-byte loads."""
    if q.dtype != torch.float32:
        raise ValueError(f"{kernel}: q is {q.dtype}, expected float32 "
                         f"(concat(q_abs, q_rope))")
    rd = q.shape[-1] - r
    dp = latent_pages.shape[-1]
    if not 0 < r <= MLA_MAX_R or rd < 0 or r + rd > MLA_MAX_L:
        raise ValueError(f"{kernel}: kv_lora_rank {r} / rope_dim {rd} not "
                         f"supported (r <= {MLA_MAX_R}, r + rd <= "
                         f"{MLA_MAX_L})")
    if dp < r + rd or (dp * latent_pages.element_size()) % 16:
        raise ValueError(f"{kernel}: latent pool width {dp} must hold "
                         f"r + rd = {r + rd} features in whole 16-byte "
                         f"loads")
    return r, rd, dp


def check_quant(kernel: str, dtype: torch.dtype) -> int:
    """The kernel's code for a quantized pool dtype; raises on others."""
    if dtype not in QUANT_CODES:
        raise ValueError(f"{kernel}: pool dtype {dtype} is not supported "
                         f"(int8, float8_e4m3fn)")
    return QUANT_CODES[dtype]


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on_error(kernel: str, lib: ctypes.CDLL, status: int) -> None:
    if status:
        msg = lib.rt_error_string(status).decode()
        raise RuntimeError(f"{kernel}: launch failed with CUDA error "
                           f"{status} ({msg})")
