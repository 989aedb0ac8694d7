"""Data of the port: tokenizers, the synthetic dataset, collation and the
loader (numpy on the host; mel on a device only for raw-audio items)."""

from sar_tpu_torch.data.collate import (LIDCollator, SpeechCollator,  # noqa: F401
                                        create_collator)
from sar_tpu_torch.data.datasets import ASRDataset, create_dataset  # noqa: F401
from sar_tpu_torch.data.loader import DataLoader  # noqa: F401
from sar_tpu_torch.data.synthetic import SyntheticASRDataset  # noqa: F401
from sar_tpu_torch.data.tokenizer import CharTokenizer, get_tokenizer  # noqa: F401
