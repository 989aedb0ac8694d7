"""ctypes binding of the native edit distance (the edit-distance part of
sar_tpu/utils/native.py).

At first use it compiles `native/edit_distance.cpp` with g++ into
`build/sar_tpu_torch/native/<content hash>/` (git-ignored) and never writes
into `native/`. Without a compiler, or when the build fails, callers take
the numpy DP (training/metrics.py); `ACTIVE_PATH` and the log say which
path ran. Host code: the card does not run it.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "edit_distance.cpp"
BUILD_ROOT = REPO / "build" / "sar_tpu_torch" / "native"
FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False
ACTIVE_PATH: str | None = None   # "native" or "numpy", once decided


def _build() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + SOURCE.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib_path = out_dir / "libsar_edit_distance.so"
    if lib_path.is_file():
        return lib_path
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) on PATH")
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        so = Path(tmp) / lib_path.name
        subprocess.run([cxx, *FLAGS, "-o", str(so), str(SOURCE)], check=True,
                       capture_output=True, timeout=120)
        os.replace(so, lib_path)
    logger.info("built %s", lib_path)
    return lib_path


def _load() -> ctypes.CDLL | None:
    global _lib, _tried, ACTIVE_PATH
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(_build()))
            i32p, i64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
            lib.batch_edit_distance_i32.restype = None
            lib.batch_edit_distance_i32.argtypes = [i32p, i64p, i32p, i64p,
                                                    ctypes.c_int64, i64p]
            _lib, ACTIVE_PATH = lib, "native"
            logger.info("edit distance: native path (%s)", SOURCE.name)
        except Exception as e:   # no compiler / unwritable dir -> numpy DP
            _lib, ACTIVE_PATH = None, "numpy"
            logger.info("edit distance: numpy path (native unavailable: %s)", e)
        return _lib


def native_available() -> bool:
    return _load() is not None


def _csr(seqs: list[np.ndarray]):
    off = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=off[1:])
    flat = (np.concatenate(seqs) if seqs and off[-1] > 0
            else np.zeros(0, np.int32)).astype(np.int32)
    return flat, off


def batch_edit_distance(a_seqs: list[np.ndarray],
                        b_seqs: list[np.ndarray]) -> np.ndarray | None:
    """Levenshtein distances of int32 id sequences, pair by pair; None when
    the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    a_flat, a_off = _csr(a_seqs)
    b_flat, b_off = _csr(b_seqs)
    out = np.zeros(len(a_seqs), np.int64)
    i32p, i64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
    lib.batch_edit_distance_i32(
        a_flat.ctypes.data_as(i32p), a_off.ctypes.data_as(i64p),
        b_flat.ctypes.data_as(i32p), b_off.ctypes.data_as(i64p),
        len(a_seqs), out.ctypes.data_as(i64p))
    return out
