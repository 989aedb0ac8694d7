"""encoder (convolutional branches): device ms per batch of the program's
`ebf.cgmlp` and `ebf.merge` spans (each E-Branchformer block's cgMLP
branch and its merge of the two branches, both with a depthwise time
convolution) in the profiled batch, summed. None unless each span was
recorded once per block that the program's block counter saw run in that
batch (a whole number of batches of `encoder_layers` blocks), so that a
span lost or doubled is no reading."""
from benchmarks.metrics._program import spans


def read(trace):
    blocks = trace.counters.get("ebf_blocks_profiled")
    L = trace.config.get("encoder_layers")
    if not blocks or not L or blocks % L:
        return None
    found = [spans(trace, name) for name in ("ebf.cgmlp", "ebf.merge")]
    if any(len(rs) != blocks or any(r.device_ms is None for r in rs) for rs in found):
        return None
    return sum(r.device_ms for rs in found for r in rs) / (blocks // L)
