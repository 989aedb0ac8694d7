"""Batch collation for seq2seq ASR (counterpart of sar_tpu/data/collate.py).

Mel features are fixed-shape (Whisper's 30 s window) and stacked as they
are; labels are padded to a static length (or a bucketed multiple) with
-100; a leading SOT shared by every row is stripped (the model prepends
it). Items that carry raw "audio" instead of features go through the
port's mel frontend (ops/mel.py) on the collator's `device`, which is
resolved as the entry points resolve theirs (the CUDA card unless given).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from sar_tpu_torch.device import resolve_device
from sar_tpu_torch.ops import mel as mel_ops

LABEL_PAD = -100


def batch_features(items: list[dict], num_mels: int = 80,
                   num_frames: int | None = None, device=None):
    """Stacked "input_features" as numpy [B, M, T]; for raw-audio items,
    the 30 s windows' Whisper log-mel on `device`, as a tensor there, as
    the JAX package's collator computes them (a config with another
    frontend takes its features from models/frontend.py instead)."""
    if "input_features" in items[0]:
        return np.stack([np.asarray(it["input_features"], np.float32)
                         for it in items])
    audio = mel_ops.stack_pad_audio([it["audio"] for it in items])
    feats = mel_ops.log_mel_spectrogram(
        torch.from_numpy(audio).to(resolve_device(device)), num_mels)
    return feats if num_frames is None else feats[:, :, :num_frames]


@dataclasses.dataclass
class SpeechCollator:
    """Collates items {"input_features": [M, T], "labels": list[int],
    "text": str, optional "language_id": int}."""

    decoder_start_token_id: int
    pad_to_length: int = 448
    pad_to_multiple: int | None = None   # bucket instead of fixed length
    with_language: bool = False
    num_mels: int = 80                   # used only for the raw-audio path
    num_frames: int | None = None        # crop mel frames (model input size)
    device: Any = None                   # the raw-audio path's device

    def __call__(self, items: list[dict]) -> dict:
        feats = batch_features(items, self.num_mels, self.num_frames, self.device)
        labels = [list(it["labels"]) for it in items]
        if labels and all(l and l[0] == self.decoder_start_token_id for l in labels):
            labels = [l[1:] for l in labels]
        longest = max((len(l) for l in labels), default=1)
        if self.pad_to_multiple:
            m = self.pad_to_multiple
            target = ((longest + m - 1) // m) * m
        else:
            target = self.pad_to_length
        target = max(target, 1)
        out_labels = np.full((len(items), target), LABEL_PAD, np.int32)
        for i, l in enumerate(labels):
            l = l[:target]
            out_labels[i, :len(l)] = l
        batch = {"input_features": feats, "labels": out_labels,
                 "texts": [it.get("text", "") for it in items]}
        if self.with_language:
            batch["language_ids"] = np.asarray(
                [it["language_id"] for it in items], np.int32)
        return batch


def create_collator(decoder_start_token_id: int, with_language: bool = False,
                    **kw) -> SpeechCollator:
    return SpeechCollator(decoder_start_token_id=decoder_start_token_id,
                          with_language=with_language, **kw)


@dataclasses.dataclass
class LIDCollator:
    """Mel features + language labels for LID training, from precomputed
    features or raw audio."""

    num_mels: int = 80
    num_frames: int | None = None
    device: Any = None

    def __call__(self, items: list[dict]) -> dict:
        return {"input_features": batch_features(items, self.num_mels,
                                                 self.num_frames, self.device),
                "language_ids": np.asarray([it["language_id"] for it in items],
                                           np.int32)}
