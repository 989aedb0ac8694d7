"""Self-contained character tokenizer for `whisper-test` (a copy of
sar_tpu/data/tokenizer.py::CharTokenizer). Real Whisper vocabularies need
the HF tokenizer, which needs a download; the port's evaluator returns
token ids and decodes text only when it is given a tokenizer."""

from __future__ import annotations

from sar_tpu_torch.models.config import WhisperConfig


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
