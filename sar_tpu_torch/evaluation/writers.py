"""Transcript writers: txt / json / srt / vtt / tsv (counterpart of
sar_tpu/evaluation/writers.py; openai-whisper's WriteTXT, WriteJSON,
WriteSRT, WriteVTT and WriteTSV conventions: SRT with comma decimals and
an hour field, VTT with dot decimals and hours only when non-zero, TSV in
integer milliseconds).

Segments are (start_seconds | None, end_seconds | None, text) tuples, the
shape the long-form and timestamp paths return; an open bound falls back
to its neighbour's (or 0.0). Pure Python.
"""

from __future__ import annotations

import json


def _fmt_clock(seconds: float, *, comma: bool, hours_always: bool) -> str:
    ms = max(0, round(seconds * 1000))
    h, ms = divmod(ms, 3_600_000)
    m, ms = divmod(ms, 60_000)
    s, ms = divmod(ms, 1000)
    sep = "," if comma else "."
    if h or hours_always:
        return f"{h:02d}:{m:02d}:{s:02d}{sep}{ms:03d}"
    return f"{m:02d}:{s:02d}{sep}{ms:03d}"


def _closed(segments):
    """Fill open bounds: None start <- previous end (or 0), None end <-
    next start (or start)."""
    out = []
    prev_end = 0.0
    for i, (t0, t1, text) in enumerate(segments):
        start = prev_end if t0 is None else t0
        if t1 is None:
            nxt = next((s[0] for s in segments[i + 1:] if s[0] is not None),
                       None)
            end = nxt if nxt is not None else start
        else:
            end = t1
        out.append((start, max(end, start), text))
        prev_end = out[-1][1]
    return out


def write_txt(text: str, segments=None, words=None) -> str:
    return text.strip() + "\n"


def write_json(text: str, segments=None, words=None) -> str:
    obj = {"text": text.strip()}
    if segments is not None:
        obj["segments"] = [{"start": t0, "end": t1, "text": t}
                           for t0, t1, t in segments]
    if words is not None:
        obj["words"] = words
    return json.dumps(obj, indent=2, ensure_ascii=False) + "\n"


def write_srt(text: str, segments=None, words=None) -> str:
    lines = []
    for i, (t0, t1, t) in enumerate(_closed(segments or []), 1):
        a = _fmt_clock(t0, comma=True, hours_always=True)
        b = _fmt_clock(t1, comma=True, hours_always=True)
        lines.append(f"{i}\n{a} --> {b}\n{t.strip()}\n")
    return "\n".join(lines)


def write_vtt(text: str, segments=None, words=None) -> str:
    lines = ["WEBVTT\n"]
    for t0, t1, t in _closed(segments or []):
        a = _fmt_clock(t0, comma=False, hours_always=False)
        b = _fmt_clock(t1, comma=False, hours_always=False)
        lines.append(f"{a} --> {b}\n{t.strip()}\n")
    return "\n".join(lines)


def write_tsv(text: str, segments=None, words=None) -> str:
    lines = ["start\tend\ttext"]
    for t0, t1, t in _closed(segments or []):
        lines.append(f"{round(t0 * 1000)}\t{round(t1 * 1000)}\t{t.strip()}")
    return "\n".join(lines) + "\n"


WRITERS = {"txt": write_txt, "json": write_json, "srt": write_srt,
           "vtt": write_vtt, "tsv": write_tsv}
SEGMENT_FORMATS = ("srt", "vtt", "tsv")


def render(fmt: str, text: str, segments=None, words=None) -> str:
    return WRITERS[fmt](text, segments=segments, words=words)
