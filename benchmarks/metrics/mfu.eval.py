"""whole step: model FLOPs of the window's work (from shapes, what the
inputs need) over the window's wall time at the card's bf16 peak."""
from benchmarks.metrics._read import mfu


def read(trace):
    return mfu(trace)
