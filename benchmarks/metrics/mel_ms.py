"""frontend: device ms per batch from the batch's start (host padding and
the host-to-device copy) to the end of the log-mel spectrogram."""
from benchmarks.metrics._read import span_mean


def read(trace):
    return span_mean(trace, "frontend")
