"""Operations that OWSM's encoder needs, from shapes (the decoder, the
cross cache and the kernels K1-K3 count as Whisper's do: counts/whisper.py).

Two operations per multiply-add, what the inputs need: the subsampling's
two 3x3 stride-2 convolutions over the 3001 x 80 features and its Linear,
then per E-Branchformer block the two half-step FFNs, the MHSA (the four
projections, QK^T and PV over the valid S = 749 frames), the cgMLP (its
up projection, the depthwise convolution of the gate half, the down
projection of the gated half) and the merge (the depthwise convolution
over both branches and the projection back to d). LayerNorms, activations
and softmax are not counted. Kernels K12 (the depthwise time convolution
with its epilogue) and K13 (LayerNorm) are counted per call, as
counts/whisper.py counts K1-K3.
"""

from __future__ import annotations

from benchmarks.counts.whisper import PEAKS, bound_s, cross_cache_flops, decode_flops  # noqa: F401

FP32 = PEAKS["fp32_flops_per_s"]     # K12 sums on the CUDA cores

FRAMES = 3001        # ESPnet's centred frames of 30 s at hop 160


def subsample_flops(c: dict, B: int) -> float:
    D, M, S = c["d_model"], c["num_mel_bins"], c["max_source_positions"]
    t1, f1 = (FRAMES - 3) // 2 + 1, (M - 3) // 2 + 1
    f2 = (f1 - 3) // 2 + 1
    conv1 = 2.0 * t1 * f1 * D * 9
    conv2 = 2.0 * S * f2 * D * D * 9
    return B * (conv1 + conv2 + 2.0 * S * D * f2 * D)


def block_flops(c: dict, B: int) -> float:
    D, F, G, S = c["d_model"], c["ffn_dim"], c["cgmlp_dim"], c["max_source_positions"]
    ffn = 2 * 4.0 * S * D * F
    mhsa = 8.0 * S * D * D + 4.0 * S * S * D
    cgmlp = 2.0 * S * D * G + 2.0 * S * (G // 2) * c["cgmlp_kernel"] + 2.0 * S * (G // 2) * D
    merge = 2.0 * S * 2 * D * c["merge_kernel"] + 2.0 * S * 2 * D * D
    return B * (ffn + mhsa + cgmlp + merge)


def encoder_flops(c: dict, B: int) -> float:
    """The subsampling and every block over B 30 s windows."""
    return subsample_flops(c, B) + c["encoder_layers"] * block_flops(c, B)


def k12(B: int, S: int, C: int, K: int, gated: bool) -> tuple[float, float]:
    """K12, one depthwise time convolution over the valid S frames of C
    channels: K multiply-adds, the bias and the epilogue's multiply or add
    per value; reads x (and the gate), w and the bias, writes y, bf16."""
    values = float(B) * S * C
    return values * (2.0 * K + 2.0), 2.0 * values * (3 if gated else 2) + 2.0 * C * (K + 1)


def k12_bound_s(c: dict, B: int) -> float:
    """The least time of one batch's K12 calls: per block the cgMLP's
    gated call over half its width and the merge's residual call over
    both branches, each bounded by the larger of its operations over the
    fp32 rate and its bytes over the memory rate."""
    S, L = c["max_source_positions"], c["encoder_layers"]
    gate = k12(B, S, c["cgmlp_dim"] // 2, c["cgmlp_kernel"], True)
    merge = k12(B, S, 2 * c["d_model"], c["merge_kernel"], False)
    return L * (bound_s(*gate, peak=FP32)[0] + bound_s(*merge, peak=FP32)[0])


def k13(rows: float, D: int) -> tuple[float, float]:
    """K13, a LayerNorm of `rows` rows of D: a subtraction, a square, a
    multiply-add with the scale and bias and the two sums per value; reads
    the bf16 rows and the fp32 scale and bias, writes the bf16 rows."""
    return 8.0 * rows * D, 4.0 * rows * D + 8.0 * D


def k13_bound_s(c: dict, B: int) -> float:
    """The least time of one batch's K13 calls over the valid S frames:
    per block the LayerNorms of the two FFNs, the MHSA, the cgMLP, its gate
    half and the block's output, then the encoder's final one."""
    D, S, L = c["d_model"], c["max_source_positions"], c["encoder_layers"]
    rows = float(B) * S

    def t(width):
        return bound_s(*k13(rows, width), peak=FP32)[0]
    return L * (5 * t(D) + t(c["cgmlp_dim"] // 2)) + t(D)
