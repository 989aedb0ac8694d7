"""Dataset assembly (the synthetic part of
sar_tpu/data/datasets.py::create_dataset).

The real corpora (Common Voice, AI4Bharat, MLS, FLEURS) wait for data in
the repository: asking for one raises and says so. `synthetic` builds the
in-memory dataset (data/synthetic.py) with the JAX package's seeding and
`max_samples` subset, so a split holds the same items in both packages.
"""

from __future__ import annotations

import numpy as np

from sar_tpu_torch.data.synthetic import SyntheticASRDataset
from sar_tpu_torch.models.config import get_config

SPLIT_SEED_OFFSETS = {"train": 0, "validation": 1, "test": 2}


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
