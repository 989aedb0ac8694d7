"""ctypes bindings of the native host components (counterpart of
sar_tpu/utils/native.py): the batched edit distance, the polyphase
resampler and the DTW path of the word aligner.

At first use it compiles `native/edit_distance.cpp`, `native/resample.cpp`
and `native/dtw.cpp` with g++ into one library under
`build/sar_tpu_torch/native/<content hash>/` (git-ignored); it never loads
the committed `native/libsar_native.so` and never writes into `native/`.
Without a compiler, or when the build fails, every entry returns None and
its caller takes the JAX package's numpy twin (training/metrics.py,
data/preprocessing.py, decode/align.py); `ACTIVE_PATH` and the log say
which path ran. Host code: the card does not run it.
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
SOURCES = tuple(REPO / "native" / n
                for n in ("edit_distance.cpp", "resample.cpp", "dtw.cpp"))
BUILD_ROOT = REPO / "build" / "sar_tpu_torch" / "native"
FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False
ACTIVE_PATH: str | None = None   # "native" or "numpy", once decided


def _build() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib_path = out_dir / "libsar_native_torch.so"
    if lib_path.is_file():
        return lib_path
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) on PATH")
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        so = Path(tmp) / lib_path.name
        subprocess.run([cxx, *FLAGS, "-o", str(so), *map(str, SOURCES)],
                       check=True, capture_output=True, timeout=120)
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
            f32p = ctypes.POINTER(ctypes.c_float)
            lib.resample_poly_f32.restype = ctypes.c_int64
            lib.resample_poly_f32.argtypes = [
                f32p, ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, f32p,
                ctypes.c_int64]
            lib.dtw_path_f32.restype = ctypes.c_int64
            lib.dtw_path_f32.argtypes = [f32p, ctypes.c_int64, ctypes.c_int64,
                                         i32p, i32p, ctypes.c_int64]
            _lib, ACTIVE_PATH = lib, "native"
            logger.info("native host components: native path (%s)",
                        ", ".join(s.name for s in SOURCES))
        except Exception as e:   # no compiler / unwritable dir -> numpy twins
            _lib, ACTIVE_PATH = None, "numpy"
            logger.info("native host components: numpy path (native "
                        "unavailable: %s)", e)
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


def dtw(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray] | None:
    """Monotone min-cost DTW path through cost[N, M] (native/dtw.cpp):
    (row_indices, col_indices) in forward order, or None when the native
    library is unavailable (decode/align.py's numpy DP then runs, with the
    same tie-breaking)."""
    lib = _load()
    if lib is None:
        return None
    cost = np.ascontiguousarray(cost, np.float32)
    n, m = cost.shape
    cap = n + m
    ti = np.empty(cap, np.int32)
    tj = np.empty(cap, np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    ln = lib.dtw_path_f32(cost.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                          n, m, ti.ctypes.data_as(i32p), tj.ctypes.data_as(i32p),
                          cap)
    if ln < 0:
        return None
    return ti[:ln], tj[:ln]


def resample_poly(audio: np.ndarray, taps: np.ndarray, L: int,
                  M: int) -> np.ndarray | None:
    """Polyphase rational resampling (native/resample.cpp): the centred
    `convolve(zero_stuff_L(audio) * L, taps)[::M]`, reading only the taps
    that overlap each output sample; None when the native library is
    unavailable (data/preprocessing.py's numpy convolution then runs)."""
    lib = _load()
    if lib is None:
        return None
    audio = np.ascontiguousarray(audio, np.float32)
    taps = np.ascontiguousarray(taps, np.float64)
    n_out = (len(audio) * L + M - 1) // M
    out = np.empty(n_out, np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    wrote = lib.resample_poly_f32(
        audio.ctypes.data_as(f32p), len(audio),
        taps.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(taps),
        L, M, out.ctypes.data_as(f32p), n_out)
    return out if wrote == n_out else None
