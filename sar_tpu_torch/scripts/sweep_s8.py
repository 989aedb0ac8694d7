"""Sweep of the design choices of K7/K9's kernel (csrc/decode_s8.cu) on the
card.

    python -m sar_tpu_torch.scripts.sweep_s8 [--output build/sweep_s8.json]

Builds csrc/decode_s8.cu once per variant with -D (from which K the score
product and the P.V product run on the tensor cores, `mma.sync` m16n8k32
s8, rather than on `__dp4a`; the least slice of K7's and of K9's cluster
split; the threads per block; the k loads a lane has in flight), one nvcc
per variant, all at once, into build/s8_sweep/, and times each variant at
whisper-small B=8: K7 over a 12-layer cache of S_pad 1536 with 1500 valid
rows at K = 1, 4 and 8, K9 over a 12-layer self cache of max_len 448 at
n = 1, 67 and 448. A time is the median device ms per call over a sweep of
the 12 layers (CUDA events behind a spin kernel, as chip_smoke.py times).
Every variant is held to the plain version with chip_smoke.py's limits
(K7: 1e-3 absolute and 8e-3 of the largest entry; K9: either), and a
variant that differs from
the first only in its products to the first's output bit for bit: every
product is an exact int32. Prints one line per variant and case, the card's
name and power limit, and writes the table as JSON to --output. With
--trace every variant is built with SAR_S8_TRACE, and each case also
prints the phase times of its last launch from the kernel's global-timer
marks (the marks cost a few stores per block). Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from sar_tpu_torch.models.whisper import quantize_kv
from sar_tpu_torch.ops import _build, decode_cross
from sar_tpu_torch.ops.attic import decode_self

# name -> the SAR_S8_* defines that differ from the source's defaults
# (QK_MMA_FROM / PV_MMA_FROM: the least K whose scores / P.V run on mma,
# 9 for never; CROSS_MIN_SLICE / SELF_MIN_SLICE: K7's and K9's least
# slice; THREADS per block; LOADS: k loads per lane in flight).
VARIANTS = {
    "default": {},
    "all mma": dict(QK_MMA_FROM=1, PV_MMA_FROM=1),
    "all dp4a": dict(QK_MMA_FROM=9, PV_MMA_FROM=9),
    "mma scores only": dict(QK_MMA_FROM=1, PV_MMA_FROM=9),
    "slices 256/128": dict(CROSS_MIN_SLICE=256, SELF_MIN_SLICE=128),
    "slices 768/224": dict(CROSS_MIN_SLICE=768, SELF_MIN_SLICE=224),
    "128 threads": dict(THREADS=128),
    "16 loads": dict(LOADS=16),
}
PRODUCT_DEFINES = ("QK_MMA_FROM", "PV_MMA_FROM")
L, B, H, S_PAD, S_VALID, MAX_LEN = 12, 8, 12, 1536, 1500, 448
D = H * 64
WIDTHS = (1, 4, 8)
LENGTHS = (1, 67, 448)
ABS_TOL, REL_TOL = 1e-3, 8e-3
RUNS = 20
SPIN_CYCLES = 50_000_000


TRACE_MARKS = ("start", "scores", "stats posted", "exchange 1", "global stats",
               "max |pw| exchange", "P.V", "exchange 3", "stored")
TRACE_BLOCKS = 1024


def source_defaults() -> dict:
    """The SAR_S8_* defaults of csrc/decode_s8.cu."""
    text = (_build.CSRC / "decode_s8.cu").read_text()
    return {m[0]: int(m[1]) for m in re.findall(r"#define SAR_S8_(\w+) (\d+)", text)
            if m[0] != "TRACE"}


def build(out_root: Path, variants: dict, trace: bool = False) -> dict:
    """name -> (library, nvcc's -Xptxas -v report, its defines) of every
    variant."""
    nvcc = _build.find_nvcc()
    src = _build.CSRC / "decode_s8.cu"
    cmds, paths, defines = [], {}, {}
    for name, over in variants.items():
        defines[name] = d = {**source_defaults(), **over, "TRACE": int(trace)}
        out = out_root / "_".join(f"{k.lower()}{v}" for k, v in sorted(d.items()))
        out.mkdir(parents=True, exist_ok=True)
        paths[name] = out / "libs8.so"
        cmds.append([nvcc, *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC),
                     *(f"-DSAR_S8_{k}={v}" for k, v in d.items()), "-o", str(paths[name]),
                     str(src)])
    logs = _build._run_all(cmds)
    libs = {}
    for (name, path), log in zip(paths.items(), logs):
        lib = ctypes.CDLL(str(path))
        for fn in ("sar_cross_decode_s8", "sar_self_decode_s8", "sar_s8_cluster_size"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        if trace:
            lib.sar_s8_trace.argtypes = [ctypes.c_void_p]
            lib.sar_s8_trace.restype = ctypes.c_int
        libs[name] = (lib, log, defines[name])
    return libs


def read_trace(lib, n_blocks: int) -> dict:
    """The phase ends of the last launch's first n_blocks blocks that ran
    through (global timer, ns): the launch's span, the spread of the blocks' starts, and per
    phase the median and largest time since its block's previous mark and
    the median end since the launch's first start."""
    import numpy as np
    buf = np.zeros((TRACE_BLOCKS, len(TRACE_MARKS)), dtype=np.uint64)
    _build.check(lib.sar_s8_trace(buf.ctypes.data), "sar_s8_trace")
    t = buf[:min(n_blocks, TRACE_BLOCKS)].astype(np.int64)
    # Blocks that left at once (K9's other ranks when rank 0 runs alone)
    # keep an earlier launch's marks.
    t = t[(t[:, 0] > t[:, 0].max() - 1_000_000) & (t[:, -1] >= t[:, 0])]
    t0 = t[:, 0].min()
    rel, step = t - t0, np.diff(t, axis=1)
    starts = np.percentile(rel[:, 0], [50, 90, 100])
    return {"span_us": float(rel.max()) / 1e3,
            "start_us_p50_p90_max": [float(x) / 1e3 for x in starts],
            "phases": {m: {"median_us": float(np.median(step[:, i - 1])) / 1e3,
                           "max_us": float(step[:, i - 1].max()) / 1e3,
                           "median_end_us": float(np.median(rel[:, i])) / 1e3}
                       for i, m in enumerate(TRACE_MARKS) if i > 0}}


def ptxas(log: str, K: int, mask: int) -> str:
    """'R registers, N bytes spill' of s8_decode_kernel<K, mask> in a report."""
    lines = log.splitlines()
    tag = f"s8_decode_kernelILi{K}ELi{mask}E"
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and tag in ln:
            info = " ".join(lines[i + 1:i + 4])
            regs = info.split("Used ")[1].split(" registers")[0]
            spill = info.split("bytes stack frame, ")[1].split(" bytes spill stores")[0]
            return f"{regs} registers, {spill} B spilled"
    return "not found"


def time_cuda(fn) -> float:
    """Median device ms of fn() over RUNS runs, the host ahead of the device."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(RUNS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cache(g, S: int, valid: int, device):
    """kq/vq [L, B, S, D] s8 and ks/vs [L, B, H, S] fp32, scale 0 past `valid`."""
    kq, ks = quantize_kv(torch.randn((L, B, S, H, 64), generator=g, device=device))
    vq, vs = quantize_kv(torch.randn((L, B, S, H, 64), generator=g, device=device))
    ks, vs = ks.transpose(2, 3).contiguous(), vs.transpose(2, 3).contiguous()
    ks[..., valid:] = 0
    vs[..., valid:] = 0
    return kq.reshape(L, B, S, D), ks, vq.reshape(L, B, S, D), vs


def query(g, K: int, device):
    qq, qs = quantize_kv(torch.randn((B, K, H, 64), generator=g, device=device) * 0.125)
    return qq.reshape(B, K * D) if K == 1 else qq.reshape(B, K, D), qs.reshape(B, K * H, 1)


def errors(got: list, want: list) -> tuple[float, float]:
    """Max |got - want| over the layers, and the largest such per layer over
    that layer's max |want|."""
    errs = [((a.float() - b.float()).abs().max().item(), b.float().abs().max().item())
            for a, b in zip(got, want)]
    return max(e for e, _ in errs), max(e / max(m, 1e-30) for e, m in errs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--output", default="build/sweep_s8.json")
    ap.add_argument("--trace", action="store_true",
                    help="build with SAR_S8_TRACE and print each variant's phase times "
                         "(the last layer's launch of each timed case)")
    ap.add_argument("--only", default="", help="comma-separated variant names (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_s8: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(smi)
    variants = {k: v for k, v in VARIANTS.items()
                if not args.only or k in args.only.split(",")}
    libs = build(_build.BUILD_ROOT.parent / "s8_sweep", variants, args.trace)
    g = torch.Generator(device=device).manual_seed(0)
    cross = cache(g, S_PAD, S_VALID, device)
    self_cache = cache(g, MAX_LEN, MAX_LEN, device)
    stream, dev = torch.cuda.current_stream(device).cuda_stream, device.index
    report = {"device": smi, "variants": {}}
    first: dict = {}
    for name, (lib, log, defines) in libs.items():
        # Everything but the products sets the sums' order.
        split = tuple(sorted((k, v) for k, v in defines.items() if k not in PRODUCT_DEFINES))
        row = report["variants"][name] = {
            "k7_cluster": lib.sar_s8_cluster_size(S_PAD, 0),
            "k9_cluster": lib.sar_s8_cluster_size(MAX_LEN, 1), "defines": defines,
            "k7": {}, "k9": {}}
        for K in WIDTHS:
            qq, qs = query(torch.Generator(device=device).manual_seed(K), K, device)
            out = torch.empty(qq.shape, dtype=torch.bfloat16, device=device)

            def k7(layer, out=out, qq=qq, qs=qs, K=K):
                _build.check(lib.sar_cross_decode_s8(
                    qq.data_ptr(), qs.data_ptr(), *(t.data_ptr() for t in cross),
                    out.data_ptr(), L, B, K, S_PAD, D, H, layer, dev, stream), name)
                return out
            outs = [k7(layer).clone() for layer in range(L)]
            want = [decode_cross.cross_decode_reference(qq, qs, *cross, layer=layer, n_heads=H)
                    for layer in range(L)]
            err = errors(outs, want)
            if err[0] > ABS_TOL or err[1] > REL_TOL:
                raise RuntimeError(f"{name}: K7 (K={K}) disagrees with its plain version: {err}")
            key = ("k7", K, *split)
            same = None
            if key in first:
                same = all(torch.equal(a, b) for a, b in zip(outs, first[key]))
                if not same:
                    raise RuntimeError(f"{name}: K7 (K={K}) differs from the mma/mma build")
            else:
                first[key] = outs
            ms = time_cuda(lambda: [k7(layer) for layer in range(L)]) / L
            if args.trace:
                row["k7_trace_K%d" % K] = tr = read_trace(lib, 96 * row["k7_cluster"])
                print(f"{name:20s} K7 K={K} trace: {json.dumps(tr)}")
            gb = (2 * B * S_PAD * D + 2 * 4 * B * H * S_PAD) / 1e9
            row["k7"][K] = dict(ms=ms, gbps=gb / ms * 1e3, max_abs_err=err[0],
                                bits_equal_to_mma=same, ptxas=ptxas(log, K, 0))
            print(f"{name:20s} K7 K={K}: {ms:.4f} ms, {gb / ms * 1e3:.0f} GB/s, C "
                  f"{row['k7_cluster']}, max_abs_err {err[0]:.2e}, bits equal to the "
                  f"first build with these slices: {same}, ptxas {row['k7'][K]['ptxas']}")
        qq, qs = query(torch.Generator(device=device).manual_seed(9), 1, device)
        qs = qs.reshape(B, H, 1)
        out = torch.empty((B, D), dtype=torch.bfloat16, device=device)
        for n in LENGTHS:
            def k9(layer, n=n):
                _build.check(lib.sar_self_decode_s8(
                    qq.data_ptr(), qs.data_ptr(), *(t.data_ptr() for t in self_cache), None, n,
                    out.data_ptr(), L, B, MAX_LEN, D, H, layer, dev, stream), name)
                return out
            outs = [k9(layer).clone() for layer in range(L)]
            want = [decode_self.self_decode_reference(qq, qs, *self_cache, n, layer=layer,
                                                      n_heads=H) for layer in range(L)]
            err = errors(outs, want)
            if err[0] > ABS_TOL and err[1] > REL_TOL:
                raise RuntimeError(f"{name}: K9 (n={n}) disagrees with its plain version: {err}")
            key = ("k9", n, *split)
            same = None
            if key in first:
                same = all(torch.equal(a, b) for a, b in zip(outs, first[key]))
                if not same:
                    raise RuntimeError(f"{name}: K9 (n={n}) differs from the mma/mma build")
            else:
                first[key] = outs
            ms = time_cuda(lambda: [k9(layer) for layer in range(L)]) / L
            if args.trace:
                row["k9_trace_n%d" % n] = tr = read_trace(lib, 96 * row["k9_cluster"])
                print(f"{name:20s} K9 n={n} trace: {json.dumps(tr)}")
            gb = (2 * B * n * D + 2 * 4 * B * H * n) / 1e9
            row["k9"][n] = dict(ms=ms, gbps=gb / ms * 1e3, max_abs_err=err[0],
                                bits_equal_to_mma=same, ptxas=ptxas(log, 1, 1))
            print(f"{name:20s} K9 n={n}: {ms:.4f} ms, {gb / ms * 1e3:.0f} GB/s, C "
                  f"{row['k9_cluster']}, max_abs_err {err[0]:.2e}, bits equal to the first "
                  f"build with these slices: {same}, ptxas {row['k9'][n]['ptxas']}")
    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    Path(args.output).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
