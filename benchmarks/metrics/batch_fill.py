"""service: the share of the batch slots that carried a request over the
window (rows served over batches x batch size, the service's counters)."""


def read(trace):
    fill = trace.extra.get("batch_fill")
    return fill if fill is not None and fill == fill else None
