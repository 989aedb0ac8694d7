"""Synthetic in-memory ASR dataset (a numpy-only copy of
sar_tpu/data/synthetic.py): for a seed its items are identical to
sar_tpu's. Mel features are a deterministic function of the text (one band
pattern per word over 8 frames, plus a per-language accent band), so a
tiny model can learn the mapping and a LID head has signal; no network,
no audio files."""

from __future__ import annotations

import numpy as np

from sar_tpu_torch.data.tokenizer import CharTokenizer
from sar_tpu_torch.models.config import WhisperConfig

_WORDS = ["aba", "bob", "cud", "dig", "eel", "fog", "gum", "hat"]


class SyntheticASRDataset:
    """List-like dataset of {"input_features", "labels", "text",
    "language_id"}; texts are `num_words` draws from an 8-word vocabulary,
    offset per language."""

    def __init__(self, cfg: WhisperConfig, size: int = 64, num_words: int = 3,
                 language: str = "english", language_id: int = 0, seed: int = 0):
        self.cfg = cfg
        self.tokenizer = CharTokenizer(cfg)
        self.language = language
        self.language_id = language_id
        # Identity keys off the language NAME, not the positional class id.
        self._accent = sum(language.encode()) % 97
        rng = np.random.default_rng(seed + 1000 * self._accent)
        self._items = []
        n_frames = cfg.max_source_positions * 2
        for _ in range(size):
            words = [_WORDS[(w + 2 * self._accent) % len(_WORDS)]
                     for w in rng.integers(0, len(_WORDS), num_words)]
            text = " ".join(words)
            self._items.append({
                "input_features": self._render(words, n_frames, rng),
                "labels": self.tokenizer.encode(text, language=language),
                "text": text,
                "language_id": language_id,
            })

    def _render(self, words: list[str], n_frames: int, rng) -> np.ndarray:
        mel = rng.standard_normal((self.cfg.num_mel_bins, n_frames)).astype(np.float32) * 0.05
        accent = (3 * self._accent) % self.cfg.num_mel_bins
        mel[accent:accent + 4, :] += 3.0
        pos = 2
        for w in words:
            band = (sum(w.encode()) * 7 + 13 * self._accent) \
                % (self.cfg.num_mel_bins - 8)
            mel[band:band + 8, pos:pos + 8] += 1.0
            pos = min(pos + 10, n_frames - 10)
        return mel

    def __len__(self):
        return len(self._items)

    def __getitem__(self, i):
        return self._items[i]
