"""WER/CER metrics (counterpart of sar_tpu/training/metrics.py): corpus
WER/CER (summed edit distance over summed reference length, can exceed
1.0) with the "<empty>" guard, per-sample metrics, and the
insertion/deletion analysis. The corpus distance takes the native C++
batch path (utils/native.py) when it builds, the numpy DP otherwise."""

from __future__ import annotations

from collections import Counter

import numpy as np

from sar_tpu_torch.utils import native


def edit_distance(ref: list, hyp: list) -> int:
    """Levenshtein distance between token sequences (vectorized row DP)."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    if m == 0:
        return n
    hyp_arr = np.asarray(hyp, dtype=object)
    idx = np.arange(m + 1)
    prev = idx.copy()
    for i in range(1, n + 1):
        sub = prev[:-1] + (hyp_arr != ref[i - 1])
        cand = np.empty(m + 1, dtype=np.int64)
        cand[0] = i
        cand[1:] = np.minimum(prev[1:] + 1, sub)
        # cur[j] = min(cand[j], cur[j-1] + 1)  ==  j + min-accumulate(cand - j)
        prev = idx + np.minimum.accumulate(cand - idx)
    return int(prev[m])


def _guard(texts: list[str]) -> list[str]:
    """An empty text counts as the one word "<empty>"."""
    return [t if t.strip() else "<empty>" for t in texts]


def _corpus_distance(ref_seqs: list[list], hyp_seqs: list[list]) -> int:
    """Total edit distance over a corpus. Tokens are interned to int32 ids,
    so the native path compares ids, not objects."""
    intern: dict = {}

    def ids(seq):
        return np.fromiter((intern.setdefault(t, len(intern)) for t in seq),
                           np.int32, count=len(seq))

    dists = native.batch_edit_distance([ids(s) for s in ref_seqs],
                                       [ids(s) for s in hyp_seqs])
    if dists is not None:
        return int(dists.sum())
    return sum(edit_distance(r, h) for r, h in zip(ref_seqs, hyp_seqs))


def compute_wer(predictions: list[str], references: list[str]) -> float:
    """Corpus WER: total word edit distance / total reference words."""
    predictions, references = _guard(predictions), _guard(references)
    dist = _corpus_distance([r.split() for r in references],
                            [p.split() for p in predictions])
    return dist / max(sum(len(r.split()) for r in references), 1)


def compute_cer(predictions: list[str], references: list[str]) -> float:
    """Corpus CER: total char edit distance / total reference chars."""
    predictions, references = _guard(predictions), _guard(references)
    dist = _corpus_distance([list(r) for r in references],
                            [list(p) for p in predictions])
    return dist / max(sum(len(r) for r in references), 1)


def compute_metrics(predictions: list[str], references: list[str]) -> dict:
    return {"wer": compute_wer(predictions, references),
            "cer": compute_cer(predictions, references)}


def compute_metrics_per_sample(predictions: list[str],
                               references: list[str]) -> list[dict]:
    """Per-sample WER/CER and word counts."""
    return [{"wer": compute_wer([p], [r]), "cer": compute_cer([p], [r]),
             "ref_words": len(r.split()), "pred_words": len(p.split())}
            for p, r in zip(predictions, references)]


def analyze_errors(predictions: list[str], references: list[str],
                   top_k: int = 10) -> dict:
    """Words inserted (in a prediction, not its reference) and deleted
    (the other way round), counted once per sample."""
    insertions: Counter = Counter()
    deletions: Counter = Counter()
    for p, r in zip(predictions, references):
        pw, rw = set(p.split()), set(r.split())
        insertions.update(pw - rw)
        deletions.update(rw - pw)
    return {"top_insertions": insertions.most_common(top_k),
            "top_deletions": deletions.most_common(top_k),
            "total_insertions": sum(insertions.values()),
            "total_deletions": sum(deletions.values())}
