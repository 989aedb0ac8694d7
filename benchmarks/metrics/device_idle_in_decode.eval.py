"""decode loop: the share of the profiled batch's decode loop in which no
operation ran on the card (the segment boundaries' host syncs and
launches), over the loop's interval on the device: the program's `decode`
span's device time, ending where the loop's last host sync left the device
caught up (its host start lies ahead of the device, which is still
running the encoder then)."""
from benchmarks.metrics._program import idle_within, on_device, spans


def read(trace):
    return idle_within(trace, [on_device(r) for r in spans(trace, "decode")
                               if r.device_ms is not None])
