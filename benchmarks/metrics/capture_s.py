"""decode loop (capture): seconds the process spent capturing and
instantiating CUDA graphs (the program's `graphs.CAPTURE` counter), all in
set-up unless something captured again later; None where nothing was
captured."""
from benchmarks.metrics._program import capture


def read(trace):
    counts = capture()
    return counts["seconds"] if counts else None
