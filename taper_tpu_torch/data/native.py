"""ctypes binding for the repository's native BPE routines: the port's
own copy of ``taper_tpu/data/native.py``'s loader and its two BPE entry
points.

Loads ``native/libtaperdata.so``, built from ``native/bpe.cpp`` and
``native/dataloader.cpp`` by ``make -C native`` (run here on first use
when the library is missing and ``make`` and a C++ compiler are at hand).
Without the library every entry point returns None, and the tokenizer
runs its NumPy path, which gives the same merges and ids
(``native/bpe.cpp`` is exactly equal to the Python trainer).  This is host
code, not a device kernel.  The dataloader and renderer entry points of
the library are not bound here (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
LIB_PATH = os.path.join(NATIVE_DIR, "libtaperdata.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def load() -> Optional[ctypes.CDLL]:
    """Load (building it first if it is missing) the native library; None
    when it cannot be built or loaded."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(LIB_PATH):
        try:
            subprocess.run(["make", "-C", NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(LIB_PATH)
        lib.taper_bpe_train.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)]
        lib.taper_bpe_train.restype = ctypes.c_int64
        lib.taper_bpe_encode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32)]
        lib.taper_bpe_encode.restype = ctypes.c_int64
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def available() -> bool:
    return load() is not None


def bpe_train(corpus: bytes, n_merges: int) -> Optional[np.ndarray]:
    """Learn up to ``n_merges`` BPE merges: ``[k, 2]`` int32 pairs, equal
    to the Python trainer's, or None without the library."""
    lib = load()
    if lib is None or n_merges <= 0:
        return None
    buf = np.frombuffer(corpus, np.uint8)
    out = np.empty(n_merges * 2, np.int32)
    k = lib.taper_bpe_train(_u8p(buf), len(buf), n_merges, _i32p(out))
    return out[:2 * k].reshape(-1, 2)


def bpe_encode(text: bytes, merges: np.ndarray) -> Optional[np.ndarray]:
    """Encode ``text`` with rank-ordered ``merges [k, 2]`` int32, or None
    without the library."""
    lib = load()
    if lib is None:
        return None
    buf = np.frombuffer(text, np.uint8)
    if len(buf) == 0:
        return np.empty(0, np.int32)
    merges = np.ascontiguousarray(merges, np.int32)
    out = np.empty(len(buf), np.int32)
    n = lib.taper_bpe_encode(_u8p(buf), len(buf), _i32p(merges),
                             len(merges), _i32p(out))
    return out[:n].copy()
