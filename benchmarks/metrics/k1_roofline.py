"""K1 (encoder attention, head-minor): its bound over its device time in
the profiled batch; one call per encoder layer, at the valid S = 1500."""
from benchmarks.counts import whisper as counts
from benchmarks.metrics._read import roofline


def read(trace):
    c, w = trace.config, trace.profiled_work
    if not w.get("k1_calls"):
        return None
    H = c["encoder_heads"]
    ops, nbytes = counts.k1(w["batch"], H, c["max_source_positions"], c["d_model"] // H)
    return roofline(trace, ("flash_fwd_kernel",), w["k1_calls"] * counts.bound_s(ops, nbytes)[0])
