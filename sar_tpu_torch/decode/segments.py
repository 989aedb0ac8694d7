"""The segment grid of the decode loops and their host-side counters.

The JAX package splits its greedy and beam loops into static segments
(`segment`, default 32; sar_tpu/decode/greedy.py and beam.py): segment s
runs positions [s * segment, min((s + 1) * segment, total - 1)) over
self-attention buffers of hi_s = min((s + 1) * segment, total) rows;
`segment=0`, or a segment that covers the loop, is one segment of the
whole length. The port keeps that grid: each segment is one program (a
host loop of decode steps, or one CUDA graph of them, decode/graphs.py),
and the host asks whether to stop once per segment, not once per step.

HOST_SYNCS counts those questions (each reads one flag from the device),
and STEPS the decode steps run, by path. Like the kernels' launch counters
they are process-wide integers that tests and chip_smoke.py zero and read;
a CUDA graph's replay adds the steps it recorded (decode/graphs.py).
"""

from __future__ import annotations

import torch

HOST_SYNCS = 0
# Decode steps run: over the int8 head-minor cache (greedy, beams, s8
# scores) or over a classic-layout cache (plain, int8, int4).
STEPS = dict.fromkeys(("greedy", "beam", "s8", "classic"), 0)


def grid(total: int, segment: int) -> list[tuple[int, int, int]]:
    """[(first pos, end pos, self rows)] of each segment of a loop over
    positions [0, total - 1): JAX's grid, one segment when `segment` is 0
    or covers the loop."""
    if segment < 0:
        raise ValueError(f"segment must be >= 0, got {segment}")
    if not segment or segment >= total - 1:
        return [(0, total - 1, total)]
    n_seg = (total - 2) // segment + 1
    return [(s * segment, min((s + 1) * segment, total - 1),
             min((s + 1) * segment, total)) for s in range(n_seg)]


def step_kind(cache, beam_width: int, scores_int8: bool) -> str:
    """The STEPS key of a decode step over `cache`."""
    if cache.cross_k.dim() != 4:
        return "classic"
    if scores_int8:
        return "s8"
    return "beam" if beam_width > 1 else "greedy"


def host_flag(flag: torch.Tensor) -> bool:
    """A 0-d bool device tensor read on the host: one sync, counted."""
    global HOST_SYNCS
    HOST_SYNCS += 1
    return bool(flag)
