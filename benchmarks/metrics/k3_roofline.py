"""K3 (one step's cross-attention over the int8 cache): its byte bound over
its device time in the profiled batch; one call per layer per step."""
from benchmarks.counts import whisper as counts
from benchmarks.metrics._read import roofline


def read(trace):
    c, w = trace.config, trace.profiled_work
    if not w.get("k3_calls"):
        return None
    ops, nbytes = counts.k3(w["batch"], c["max_source_positions"], c["d_model"],
                            c["decoder_heads"])
    return roofline(trace, ("cross_decode_exact_kernel",),
                    w["k3_calls"] * counts.bound_s(ops, nbytes)[0])
