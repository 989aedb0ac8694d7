"""Datasets: `ASRDataset` over local items, and dataset assembly (the
synthetic part of sar_tpu/data/datasets.py::create_dataset).

`ASRDataset` wraps any sequence of {"audio", "text"} dicts (audio as
{"array", "sampling_rate"} or a raw 16 kHz array) and applies the JAX
package's eager filters: duration in [1, 30] s from len(array) / sr, and
labels of at most 448 tokens with the special tokens; a sample whose check
raises is kept, as there. Items carry the raw 16 kHz waveform (dict audio
through `AudioPreprocessor`); log-mel runs batched on the device in the
collator. `_ConcatDataset` chains datasets end to end.

The real corpora (Common Voice, AI4Bharat, MLS, FLEURS) wait for data in
the repository: asking for one raises and says so. `synthetic` builds the
in-memory dataset (data/synthetic.py) with the JAX package's seeding and
`max_samples` subset, so a split holds the same items in both packages.
"""

from __future__ import annotations

import logging

import numpy as np

from sar_tpu_torch.data.preprocessing import AudioPreprocessor
from sar_tpu_torch.data.synthetic import SyntheticASRDataset
from sar_tpu_torch.models.config import get_config

logger = logging.getLogger(__name__)

MAX_LABEL_LENGTH = 448   # Whisper's decoder positions
SPLIT_SEED_OFFSETS = {"train": 0, "validation": 1, "test": 2}


class ASRDataset:
    """List-like dataset of {"audio", "labels", "text", "language_id"}
    over `hf_dataset`, any sequence of dicts with "audio" ({"array",
    "sampling_rate"} or a raw array at 16 kHz) and "text"."""

    def __init__(self, hf_dataset, tokenizer, language: str = "hindi",
                 language_id: int = 0, min_duration: float = 1.0,
                 max_duration: float = 30.0,
                 max_label_length: int = MAX_LABEL_LENGTH,
                 preprocessor: AudioPreprocessor | None = None):
        self.tokenizer = tokenizer
        self.language = language
        self.language_id = language_id
        self.preprocessor = preprocessor or AudioPreprocessor(max_duration=None)
        self._ds = hf_dataset
        # The eager filter pass; a check that raises keeps the sample.
        keep = []
        for i in range(len(hf_dataset)):
            try:
                item = hf_dataset[i]
                audio = item["audio"]
                arr = audio["array"] if isinstance(audio, dict) else audio
                sr = audio.get("sampling_rate", 16_000) if isinstance(audio, dict) else 16_000
                if not min_duration <= len(arr) / sr <= max_duration:
                    continue
                if len(tokenizer.encode(item["text"], language=language)) > max_label_length:
                    continue
                keep.append(i)
            except Exception:           # noqa: BLE001
                keep.append(i)
        dropped = len(hf_dataset) - len(keep)
        if dropped:
            logger.info("ASRDataset[%s]: filtered %d/%d samples",
                        language, dropped, len(hf_dataset))
        self._indices = keep

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, i):
        item = self._ds[self._indices[i]]
        audio = item["audio"]
        if isinstance(audio, dict):
            arr = self.preprocessor(np.asarray(audio["array"], np.float32),
                                    int(audio.get("sampling_rate", 16_000)))
        else:
            arr = np.asarray(audio, np.float32)
        return {"audio": arr,
                "labels": self.tokenizer.encode(item["text"], language=self.language),
                "text": item["text"],
                "language_id": self.language_id}


class _ConcatDataset:
    def __init__(self, parts):
        self._parts = parts
        self._offsets = np.cumsum([0] + [len(p) for p in parts])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, i):
        p = int(np.searchsorted(self._offsets, i, side="right")) - 1
        return self._parts[p][i - int(self._offsets[p])]


class _SubsetDataset:
    def __init__(self, ds, indices):
        self._ds, self._idx = ds, list(indices)

    def __len__(self):
        return len(self._idx)

    def __getitem__(self, i):
        return self._ds[self._idx[i]]


def create_dataset(language: str, sources: list[str] | None = None,
                   split: str = "train", language_id: int = 0,
                   max_samples: int | None = None, seed: int = 42,
                   synthetic_size: int = 64, model_config=None):
    """The synthetic split of one language: `synthetic_size` items seeded
    by `seed` and the split, then `max_samples` of them drawn without
    replacement, as in the JAX package. Items carry input_features and
    labels, so no tokenizer is needed."""
    if list(sources or []) != ["synthetic"]:
        raise NotImplementedError(
            f"data sources {sources}: sar_tpu_torch has the 'synthetic' "
            f"source only; the real corpora wait for data in the repository")
    ds = SyntheticASRDataset(
        model_config or get_config("whisper-test"), size=synthetic_size,
        language=language, language_id=language_id,
        seed=seed + SPLIT_SEED_OFFSETS.get(split, 3))
    if max_samples is not None and len(ds) > max_samples:
        idx = np.random.default_rng(seed).permutation(len(ds))[:max_samples]
        return _SubsetDataset(ds, idx)
    return ds
