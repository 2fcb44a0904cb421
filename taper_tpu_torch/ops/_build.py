"""Build and load the hand-written CUDA kernels (``taper_tpu_torch/csrc``).

Pallas compiles a kernel on its first call; the port does the same for the
whole kernel library.  The first call that needs a kernel compiles every
``csrc/*.cu`` with ``nvcc``, one process per source, all started together,
links the objects into one shared library with a plain C interface, under
``build/taper_tpu_torch/`` at the root of the checkout, and loads it with
``ctypes``.  The library's name carries a hash of the
sources and the flags, so an edited source is rebuilt and an unchanged one
is loaded as it is.  Nothing here runs at import time.

The C entry points take device pointers as ``c_void_p``, sizes as
``c_int``, and PyTorch's current CUDA stream; each returns
``cudaGetLastError()`` after its launch, and :func:`check` raises on a
non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "taper_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC",
              # register/spill report, kept next to the library
              "-Xptxas", "-v")

# dtype codes of csrc/common.cuh
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_int64
_SIGNATURES = {
    # a, b, bias, y, workspace, M, N, K, mode, dtype, out dtype, act,
    # route, splits, stream
    "taper_gemm": [_P] * 5 + [_I] * 9 + [_P],
    # x, w, bias, y, N, C, H, W, O, kh, kw, ph, pw, act, flipped, stream
    "taper_conv_fwd": [_P, _P, _P, _P] + [_I] * 11 + [_P],
    # x, g, part, dw, N, C, H, W, O, kh, kw, ph, pw, splits, stream
    "taper_conv_dw": [_P, _P, _P, _P] + [_I] * 11 + [_P],
    # x, y, planes, H, W, kh, kw, mode, stream
    "taper_pool": [_P, _P, _I, _I, _I, _I, _I, _I, _P],
    # q, k, v, o, lse, seg, B, H, Hkv, S, D, scale, causal, window, layout,
    # dtype, stream
    "taper_flash_fwd": [_P] * 6 + [_I] * 5 + [_F] + [_I] * 4 + [_P],
    # q, k, v, o, lse, kn, pred, bound_count, B, H, Hkv, S, D, scale,
    # layout, stream
    "taper_flash_fwd_bound": [_P] * 8 + [_I] * 5 + [_F, _I, _P],
    # q, k, v, o, do, lse, dq, delta, seg, B, H, Hkv, S, D, scale, causal,
    # window, layout, dtype, stream
    "taper_flash_dq": [_P] * 9 + [_I] * 5 + [_F] + [_I] * 4 + [_P],
    # q, k, v, do, lse, delta, dk, dv, seg, B, H, Hkv, S, D, scale, causal,
    # window, layout, dtype, stream
    "taper_flash_dkv": [_P] * 9 + [_I] * 5 + [_F] + [_I] * 4 + [_P],
    # q, k, v, do, lse, delta, dk_part, dv_part, B, H, Hkv, S, D, scale,
    # causal, window, layout, dtype, stream
    "taper_flash_dkv_t": [_P] * 8 + [_I] * 5 + [_F] + [_I] * 4 + [_P],
    # q, k, v, o, do, lse, delta, dq_acc, dq, dk, dv, seg, B, H, Hkv, S, D,
    # scale, causal, window, layout, dtype, stream
    "taper_flash_bwd_fused": [_P] * 12 + [_I] * 5 + [_F] + [_I] * 4 + [_P],
    # a, b, c, out, row max, row sum, n, stream (a card test of the wgmma
    # fragment helpers of csrc/hopper.cuh)
    "taper_wgmma_frag_test": [_P] * 6 + [_I, _P],
    # q, k_pool, v_pool, tables, lengths, o, B, kvh, G, D, bs, mb, scale,
    # dtype, stream
    "taper_paged_decode": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _F, _I, _P],
    # q, k_pool, v_pool, k_scales, v_scales, tables, lengths, o, B, kvh, G,
    # D, bs, mb, scale, q dtype, stream
    "taper_paged_decode_int8": [_P] * 8 + [_I] * 6 + [_F, _I, _P],
    # a, b, c, y, n, op, dtype, stream
    "taper_elementwise": [_P, _P, _P, _P, _L, _I, _I, _P],
    # host arrays p, g, m, v (device pointers), n (sizes), count, lr,
    # step_size, b1, 1 - b1, b2, 1 - b2, eps, wd, decoupled, stream
    "taper_adam": [_P] * 5 + [_I] + [_F] * 8 + [_I, _P],
    # host arrays p, g, m (null without momentum), n, count, lr,
    # momentum, wd, stream
    "taper_sgd": [_P] * 4 + [_I] + [_F] * 3 + [_P],
    # x, q, scale, zp, bias, y, M, N, K, bits (8 or 4), act, stream
    "taper_linear_q": [_P] * 6 + [_I] * 5 + [_P],
    # x, xq, sx, xsum, M, K, dtype, stream
    "taper_quantize_rows": [_P] * 4 + [_I] * 3 + [_P],
    # xq, q, sx, corr, sw, zw, bias, y, M, N, K, relu, out dtype, stream
    "taper_matmul_int8": [_P] * 8 + [_I] * 5 + [_P],
}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of taper_tpu_torch "
                       "are built with the CUDA toolkit's nvcc")


def library_path() -> Path:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtaper_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless a library for these sources exists;
    returns its path.  Raises with nvcc's output when nvcc fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    sources = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in ([_nvcc(), *NVCC_FLAGS, "-c", str(src), "-o",
                          str(obj)] for src, obj in zip(sources, objs))]
    report, failed = [], []
    for cmd, proc in procs:
        text = proc.communicate()[0]
        report.append(text)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{text}")
    tmp = out.with_name(f"{tag}.so.tmp")
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        cmd = [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {proc.returncode}):"
                               f"\n{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        out.with_suffix(".ptxas.txt").write_text("".join(report))
        os.replace(tmp, out)   # atomic: a concurrent builder sees all or none
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.taper_error_string.argtypes = [ctypes.c_int]
        lib.taper_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if code != 0:
        msg = library().taper_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream
