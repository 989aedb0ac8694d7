"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` file is compiled by its own `nvcc` process (all started
together, so the build takes as long as the slowest source) and the
objects are linked into ONE shared library with a plain C interface
(`libsar_kernels.so`), which is loaded with ctypes. The build runs at the
first launch of any kernel, never at import, and lands in
`build/sar_tpu_torch/<content hash>/` beside the package (git-ignored): an
unchanged source tree reuses the library, an edited one rebuilds.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()` after its launch; `check()` turns a non-zero code into
an exception (a refused launch never runs, and a later synchronize would
not report it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "sar_tpu_torch"
LIB_NAME = "libsar_kernels.so"
# No --use_fast_math: the int8 quantization divides y / scale and must round
# exactly like the reference (approximate division flips values at .5).
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LP = ctypes.POINTER(ctypes.c_longlong)   # a host array of int64 strides
_LL = ctypes.c_longlong
# C entry point -> argtypes (pointers and the stream as c_void_p, ints c_int).
SIGNATURES = {
    # q, k, v, o, lse, strides (q, k, v, o), B, H, Tq, Tk, causal, device,
    # stream
    "sar_flash_attn_fwd": [_P, _P, _P, _P, _P, _LP, _I, _I, _I, _I, _I, _I, _P],
    # q, k, v, do, lse, di, dk, dv, strides (q, k, v, do, dk, dv), B, H, Tq,
    # Tk, causal, device, stream
    "sar_flash_attn_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _LP,
                               _I, _I, _I, _I, _I, _I, _P],
    # q, k, v, do, lse, di, dq, strides (q, k, v, do, dq), B, H, Tq, Tk,
    # causal, device, stream
    "sar_flash_attn_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _LP,
                              _I, _I, _I, _I, _I, _I, _P],
    # q, k, v, out, B, T, D, n_heads, t_valid, device, stream
    "sar_encoder_attention_hm": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, ln_scale, ln_bias, wq, bq, wk, wv, bv, qkv scratch, out, B, T, D,
    # n_heads, t_valid, device, stream
    "sar_encoder_attention_fused": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _P],
    # x, ln_scale, ln_bias, wq, bq, wk, wv, bv, qkv, B, T, D, device, stream
    "sar_encoder_ln_qkv": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _P],
    # qq, qs, kq, ks, vq, vs, n (device int32 or NULL), n_host, out, L, B,
    # S, D, n_heads, layer, device, stream
    "sar_self_decode_s8": [_P, _P, _P, _P, _P, _P, _P, _I, _P,
                           _I, _I, _I, _I, _I, _I, _I, _P],
    # q, k, v, n (device int32 or NULL), n_host, out, B, H, S, device, stream
    "sar_decode_attention": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _P],
    # x, wk, wv, bv, kq, ks, vq, vs, L, B, S_pad, D, n_heads, t_valid,
    # device, stream
    "sar_fused_kv_init": [_P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _I, _P],
    # x, wk, wv, bv, va, vb, u scratch, kq, ks, vq, vs, L, B, Bv, S_pad, D,
    # n_heads, rank, t_valid, lora_scale, device, stream
    "sar_fused_kv_init_lora": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    # q, kq, ks, vq, vs, out, L, B, S_pad, D, n_heads, layer, device, stream
    "sar_cross_decode_exact": [_P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _P],
    # q, kq, ks, vq, vs, out, L, B, S_pad, D, n_heads, layer, form, device,
    # stream
    "sar_cross_decode_exact_form": [_P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # B, n_heads, S_pad, device -> the heads per item of K3's large-batch
    # form, or 0 for its cluster form
    "sar_cross_decode_form": [_I, _I, _I, _I],
    # q, kq, ks, vq, vs, out, L, B, K, S_pad, D, n_heads, layer, device,
    # stream
    "sar_cross_decode_exact_beam": [_P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # qq, qs, kq, ks, vq, vs, out, L, B, K, S_pad, D, n_heads, layer,
    # device, stream
    "sar_cross_decode_s8": [_P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # qq, qs, kq, ks, vq, vs, n (device int32 or NULL), n_host, out,
    # probe_pw, probe_ps, probe_pq, L, B, K, S, D, n_heads, layer,
    # length_mask, device, stream
    "sar_s8_decode_probe": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # S, length_mask (K9's split if not 0) -> the cluster size K7/K9 launch
    "sar_s8_cluster_size": [_I, _I],
    # q, kq, ks, vq, vs, out, L, B, H, T, hd, layer, pos, device, stream
    "sar_self_decode_exact": [_P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, w, bias, gate (or NULL), y, B, T, C, K, t_valid, gate row stride,
    # residual, device, stream
    "sar_dwconv_time": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, scale, bias, y, B, T, D, x's batch and row strides, eps, device,
    # stream
    "sar_layer_norm_rows": [_P, _P, _P, _P, _I, _I, _I, _LL, _LL, _F, _I, _P],
    # x, y, b (or NULL), scale, bias, x_new, h, N, D, eps, device, stream
    "sar_add_layer_norm_rows": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
BUILD_SECONDS: float | None = None   # wall time of this process's build
BUILD_LOG: str = ""                  # nvcc's -Xptxas -v reports


def sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """nvcc from CUDA_HOME (or CUDA_PATH), then PATH, then the toolkit
    directory torch was told about; raises if there is none."""
    for var in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(var)
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME   # the toolkit torch found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").is_file():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (checked CUDA_HOME, CUDA_PATH, PATH and torch's "
        "CUDA_HOME): the sar_tpu_torch CUDA kernels are built from "
        "sar_tpu_torch/csrc at first use and need the CUDA toolkit")


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands concurrently, wait for every one, and return their
    output; raises with the first failure's output once all have ended."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(c)}"
                               f"\n{out}")
    return outs


def build() -> Path:
    """Compile csrc/*.cu into the content-addressed library (no-op when it
    exists) and return its path: one nvcc per source, all at once, then
    one link."""
    global BUILD_SECONDS, BUILD_LOG
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.is_file():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    # Objects and the library are built in a private directory and the
    # library renamed into place: a concurrent build never loads a
    # half-written library.
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        cu = [p for p in sources() if p.suffix == ".cu"]
        objs = [str(Path(tmp) / f"{p.stem}.o") for p in cu]
        logs = _run_all([[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", o,
                          str(p)] for p, o in zip(cu, objs)])
        so = str(Path(tmp) / LIB_NAME)
        logs += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", so, *objs]])
        os.replace(so, lib_path)
    BUILD_SECONDS = time.perf_counter() - t0
    BUILD_LOG = "".join(logs)
    (out_dir / "build.log").write_text(BUILD_LOG)
    return lib_path


def load() -> ctypes.CDLL:
    """Build if needed, load once per process, declare every signature."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


_SM_COUNTS: dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device (read once per device)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SM_COUNTS:
        _SM_COUNTS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SM_COUNTS[index]


def require(cond: bool, msg: str) -> None:
    """Argument check for the kernel wrappers (raises, unlike assert)."""
    if not cond:
        raise ValueError(msg)


def require_cuda_args(name: str, tensors: dict, dtypes: dict) -> None:
    """Every tensor on one CUDA device, contiguous, 16-byte aligned and of
    the dtype the kernel takes."""
    devices = {t.device for t in tensors.values()}
    require(len(devices) == 1,
            f"{name}: all tensors must be on one device, got {devices}")
    for k, t in tensors.items():
        require(t.dtype == dtypes[k],
                f"{name}: {k} must be {dtypes[k]}, got {t.dtype}")
        require(t.is_contiguous(), f"{name}: {k} must be contiguous")
        require(t.data_ptr() % 16 == 0, f"{name}: {k} must be 16-byte aligned")


def valid_len_arg(name: str, valid_len, device, S: int) -> tuple[int | None, int]:
    """(device pointer or None, host value) of a valid length: a Python int
    goes by value (checked against S here); a 0-d int32 tensor on the
    kernel's device goes by pointer, read by the kernel (the kernel clamps
    it to [0, S])."""
    if isinstance(valid_len, torch.Tensor):
        require(valid_len.dim() == 0 and valid_len.dtype == torch.int32
                and valid_len.device == device,
                f"{name}: a tensor valid_len must be 0-d int32 on {device}")
        return valid_len.data_ptr(), 0
    require(0 <= int(valid_len) <= S,
            f"{name}: valid_len {valid_len} not in [0, {S}]")
    return None, int(valid_len)
