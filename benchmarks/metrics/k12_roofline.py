"""K12 (the E-Branchformer's depthwise time convolutions with their fused
epilogue): its bound over its device time in the profiled batch; two calls
per encoder block, at the valid S = 749 frames."""
from benchmarks.counts import owsm
from benchmarks.metrics._read import roofline


def read(trace):
    c, w = trace.config, trace.profiled_work
    if not w.get("batches"):
        return None
    return roofline(trace, ("dwconv_time_kernel",), w["batches"] * owsm.k12_bound_s(c, w["batch"]))
