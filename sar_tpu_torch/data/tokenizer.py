"""Tokenizer access (counterpart of sar_tpu/data/tokenizer.py).

`whisper-test` takes the self-contained character tokenizer (a copy of
sar_tpu's CharTokenizer). Real Whisper vocabularies need the HF
`WhisperTokenizerFast`, which `get_tokenizer` loads from the local HF
cache only (never the network) and refuses with a clear error when it is
not there.
"""

from __future__ import annotations

from sar_tpu_torch.models.config import (HF_MODEL_IDS, LANGUAGE_CODES,
                                         MODEL_CONFIGS, WhisperConfig)


class CharTokenizer:
    """Byte-level tokenizer over a small vocab — used with `whisper-test`.

    ids 0..(n_special-1) are reserved for special tokens; bytes map to
    id = byte + n_special (mod vocab).
    """

    def __init__(self, cfg: WhisperConfig, n_special: int = 120):
        self.cfg = cfg
        self.n_special = n_special
        self.vocab_size = cfg.vocab_size

    def encode(self, text: str, language: str = "english",
               task: str = "transcribe") -> list[int]:
        body = [self.n_special + (b % (self.vocab_size - self.n_special))
                for b in text.encode("utf-8")]
        return self.cfg.prompt_ids(language, task) + body + [self.cfg.eos_token_id]

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        out = bytearray()
        for i in ids:
            i = int(i)
            if i >= self.n_special:
                out.append((i - self.n_special) % 256)
            elif not skip_special_tokens:
                out.extend(f"<|{i}|>".encode())
        return out.decode("utf-8", errors="ignore")

    def batch_decode(self, batch, skip_special_tokens: bool = True) -> list[str]:
        return [self.decode(row, skip_special_tokens) for row in batch]


def get_tokenizer(model_name: str, language: str = "hindi",
                  task: str = "transcribe"):
    """CharTokenizer for `whisper-test`; the HF Whisper tokenizer of a real
    model from the local HF cache, or a RuntimeError saying what is
    missing."""
    if model_name == "whisper-test":
        return CharTokenizer(MODEL_CONFIGS[model_name])
    hf_id = HF_MODEL_IDS.get(model_name, model_name)
    try:
        from transformers import WhisperTokenizerFast
        return WhisperTokenizerFast.from_pretrained(
            hf_id, language=LANGUAGE_CODES.get(language, language), task=task,
            local_files_only=True)
    except (ImportError, OSError) as e:
        raise RuntimeError(
            f"the tokenizer of {model_name} ({hf_id}) is not available "
            f"offline: it needs `transformers` and the tokenizer files in "
            f"the local HF cache ({type(e).__name__}: {e}); `whisper-test` "
            f"needs neither") from e
