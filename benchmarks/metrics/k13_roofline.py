"""K13 (the E-Branchformer's LayerNorms): its bound over its device time in
the profiled batch; six calls per encoder block and the final one, at the
valid S = 749 frames."""
from benchmarks.counts import owsm
from benchmarks.metrics._read import roofline


def read(trace):
    c, w = trace.config, trace.profiled_work
    if not w.get("batches"):
        return None
    return roofline(trace, ("layer_norm_rows_kernel",),
                    w["batches"] * owsm.k13_bound_s(c, w["batch"]))
