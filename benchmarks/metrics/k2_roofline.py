"""K2 (the int8 cross-KV cache of every decoder layer): its bound over its
device time in the profiled batch."""
from benchmarks.counts import whisper as counts
from benchmarks.metrics._read import roofline


def read(trace):
    c, w = trace.config, trace.profiled_work
    if not w.get("k2_calls"):
        return None
    ops, nbytes = counts.k2(w["batch"], c["max_source_positions"], c["d_model"],
                            c["decoder_layers"], c["decoder_heads"])
    return roofline(trace, ("fused_kv_init_kernel",), w["k2_calls"] * counts.bound_s(ops, nbytes)[0])
