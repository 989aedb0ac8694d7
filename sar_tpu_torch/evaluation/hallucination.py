"""openai-whisper's hallucination-silence heuristics (counterpart of
sar_tpu/evaluation/hallucination.py; openai transcribe.py's
word_anomaly_score, is_segment_anomaly, next_words_segment and get_end).

With `hallucination_silence_threshold` and word timestamps on, a segment
whose aligned words look hallucinated (improbable words, degenerate
durations) makes the conditioned long-form loop (evaluation/longform.py)
skip the silent gap around it. Segments are dicts {"start", "end",
"words"} on the global clock; words are the aligner's [{"word", "start",
"end", "probability"}]. Pure Python.
"""

from __future__ import annotations

# openai's prepend_punctuations + append_punctuations — the anomaly score
# skips pure-punctuation words.
_PUNCT = "\"'\u201c\u00bf([{-\"'.\u3002,\uff0c!\uff01?\uff1f:\uff1a\u201d)]}\u3001"


def word_anomaly_score(word: dict) -> float:
    """Anomaly score of one aligned word: improbable (p < 0.15) scores 1,
    too short (< 133 ms) up to 2 (linear in the shortfall), too long
    (> 2 s) its excess in seconds."""
    probability = word.get("probability", 0.0)
    duration = word["end"] - word["start"]
    score = 0.0
    if probability < 0.15:
        score += 1.0
    if duration < 0.133:
        score += (0.133 - duration) * 15
    if duration > 2.0:
        score += duration - 2.0
    return score


def is_segment_anomaly(segment: dict | None) -> bool:
    """Score the segment's first 8 non-punctuation words; anomalous when
    the total reaches 3 or averages ~1 per word."""
    if segment is None or not segment.get("words"):
        return False
    words = [w for w in segment["words"] if w["word"] not in _PUNCT]
    words = words[:8]
    if not words:
        return False
    score = sum(word_anomaly_score(w) for w in words)
    return score >= 3 or score + 0.01 >= len(words)


def next_words_segment(segments: list[dict]) -> dict | None:
    """First segment that carries any words."""
    return next((s for s in segments if s.get("words")), None)


def get_end(segments: list[dict]) -> float | None:
    """End time of the last aligned word, falling back to the last
    segment's end; None when there are no segments."""
    return next((w["end"] for s in reversed(segments)
                 for w in reversed(s.get("words", []))),
                segments[-1]["end"] if segments else None)
