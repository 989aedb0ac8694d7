"""The port's ASRDataset and _ConcatDataset (sar_tpu_torch/data/datasets.py)
against sar_tpu's on the same HF-style items: tests/test_datasets.py's
four oracles (the duration filter, the label-length filter, the items,
concatenation), each holding the port's kept indices and items equal to
JAX's, plus a sample whose check raises, kept as JAX keeps it; and the
loader's collation thread pool (sar_tpu_torch/data/loader.py
`num_workers`) against one thread and the JAX loader's pool
(tests/test_loader_throughput.py's oracle)."""

import numpy as np
import pytest

from sar_tpu.data.datasets import ASRDataset as JaxASRDataset
from sar_tpu.data.datasets import _ConcatDataset as JaxConcat
from sar_tpu.data.tokenizer import CharTokenizer as JaxCharTokenizer
from sar_tpu.models.config import get_config
from sar_tpu_torch.data import ASRDataset, CharTokenizer
from sar_tpu_torch.data.datasets import _ConcatDataset

CFG = get_config("whisper-test")


def _fake_hf(n, seconds, text="hello world", sr=16000):
    return [{"audio": {"array": np.random.default_rng(i).standard_normal(
        int(seconds * sr)).astype(np.float32), "sampling_rate": sr},
             "text": text} for i in range(n)]


def _both(items, **kw):
    return (ASRDataset(items, CharTokenizer(CFG), **kw),
            JaxASRDataset(items, JaxCharTokenizer(CFG), **kw))


def _assert_items_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0)
        else:
            assert got[k] == want[k]


def test_duration_filter():
    items = _fake_hf(3, 5.0) + _fake_hf(2, 0.5) + _fake_hf(2, 31.0) + _fake_hf(1, 2.0, sr=8000)
    got, want = _both(items, min_duration=1.0, max_duration=30.0)
    assert got._indices == want._indices == [0, 1, 2, 7] and len(got) == len(want) == 4


def test_label_length_filter():
    items = (_fake_hf(2, 5.0, text="ok") + _fake_hf(2, 5.0, text="x" * 500)
             + _fake_hf(1, 5.0, text="x" * 25) + _fake_hf(1, 5.0, text="x" * 26))
    got, want = _both(items, max_label_length=30)
    assert got._indices == want._indices == [0, 1, 4]     # 4 + 25 + 1 = 30 ids kept, 31 not


def test_asr_dataset_items():
    from threadpoolctl import threadpool_limits
    raw = np.random.default_rng(3).standard_normal(32000).astype(np.float32) * 0.3
    items = (_fake_hf(2, 3.0) + _fake_hf(1, 2.0, text="resampled", sr=22050)
             + [{"audio": raw, "text": "raw"}])
    got, want = _both(items, language="english", language_id=3)
    assert len(got) == len(want) == 4
    with threadpool_limits(1):      # the resample's convolution through BLAS
        for i in range(len(want)):
            _assert_items_equal(got[i], want[i])
    item = got[0]
    assert item["language_id"] == 3 and item["text"] == "hello world"
    assert item["labels"][0] == CFG.sot_token_id and item["audio"].dtype == np.float32
    assert got[3]["audio"] is raw         # a raw 16 kHz array passes straight through


def test_a_sample_whose_check_raises_is_kept():
    items = _fake_hf(2, 5.0) + [{"audio": {"array": np.zeros(16000)}, "text": None},
                                {"text": "no audio"}]
    got, want = _both(items)
    assert got._indices == want._indices == [0, 1, 2, 3]


@pytest.mark.parametrize("index", range(8))
def test_concat_dataset(index):
    parts = [_fake_hf(3, 1.0), _fake_hf(5, 1.0, text="zz")]
    got, want = _ConcatDataset(parts), JaxConcat(parts)
    assert len(got) == len(want) == 8
    assert got[index] is want[index]
    assert got[2]["text"] == "hello world" and got[3]["text"] == "zz"


@pytest.mark.parametrize("shuffle,drop_last", [(False, True), (True, False)])
def test_loader_workers_match_one_thread_and_jax(shuffle, drop_last):
    """Batches equal with and without workers, in the same order, and
    equal to the JAX loader's with its pool; over two epochs of iterate()
    too, where the pipeline crosses the epoch boundary."""
    from sar_tpu.data.collate import create_collator as jax_collator
    from sar_tpu.data.loader import DataLoader as JaxLoader
    from sar_tpu.data.synthetic import SyntheticASRDataset as JaxSynthetic
    from sar_tpu_torch.data import DataLoader, SyntheticASRDataset, create_collator

    def batches(loader, n=None):
        if n is None:
            return list(loader.one_epoch())
        it = loader.iterate()
        return [next(it) for _ in range(n)]

    kw = dict(batch_size=3, shuffle=shuffle, drop_last=drop_last, seed=4)
    ds = SyntheticASRDataset(CFG, size=10, num_words=2, seed=1)
    coll = create_collator(CFG.sot_token_id, pad_to_length=16)
    serial = DataLoader(ds, collator=coll, prefetch=0, **kw)
    pooled = DataLoader(ds, collator=coll, num_workers=3, prefetch=1, **kw)
    jax_pooled = JaxLoader(JaxSynthetic(CFG, size=10, num_words=2, seed=1),
                           collator=jax_collator(CFG.sot_token_id, pad_to_length=16),
                           num_workers=3, prefetch=1, **kw)
    for n in (None, 7):
        want = batches(serial, n)
        assert len(want) == (7 if n else 3 if drop_last else 4)
        for got in (batches(pooled, n), batches(jax_pooled, n)):
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a["input_features"], b["input_features"])
                np.testing.assert_array_equal(a["labels"], b["labels"])
                assert list(a["texts"]) == list(b["texts"])
    assert pooled.current_epoch == 2 if drop_last else pooled.current_epoch == 1
