"""Model registry and architecture configs (a copy of sar_tpu/models/config.py,
which the port keeps free of jax).

Capability parity with the reference's model registry
(reference src/models/base.py:16-36 — MODEL_NAME_MAP, LANGUAGE_CODES)
re-designed as typed dataclasses that are the live source of truth (the
reference's YAML tree is documentation-only; argparse was its real config
surface, see reference scripts/train_lora.py:32-110).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    """Whisper architecture hyperparameters (HF/OpenAI-compatible).

    Mirrors what the reference reads via get_model_info()
    (reference src/models/base.py:142-166).
    """

    name: str = "whisper-small"
    vocab_size: int = 51865
    num_mel_bins: int = 80
    d_model: int = 768
    encoder_layers: int = 12
    encoder_heads: int = 12
    decoder_layers: int = 12
    decoder_heads: int = 12
    ffn_dim: int = 3072
    max_source_positions: int = 1500   # 30 s audio -> 3000 mel frames -> /2 conv stride
    max_target_positions: int = 448

    # Special token ids (multilingual vocab).
    eos_token_id: int = 50257          # <|endoftext|>
    sot_token_id: int = 50258          # <|startoftranscript|>
    lang_token_offset: int = 50259     # <|en|> .. one id per language, in WHISPER_LANGUAGES order
    translate_token_id: int = 50358
    transcribe_token_id: int = 50359
    no_timestamps_token_id: int = 50363
    pad_token_id: int = 50257
    # Checkpoint-specific (layer, head) pairs whose cross-attention tracks
    # the audio (HF generation_config "alignment_heads"); None -> the
    # word-timestamp aligner falls back to its upper-half-layers heuristic.
    alignment_heads: tuple[tuple[int, int], ...] | None = None

    def __post_init__(self):
        if self.alignment_heads is not None:
            # Coerce JSON lists to tuples: the config doubles as a static
            # (hashable) jit argument.
            object.__setattr__(self, "alignment_heads",
                               tuple(tuple(p) for p in self.alignment_heads))

    @property
    def head_dim(self) -> int:
        return self.d_model // self.encoder_heads

    @property
    def no_speech_token_id(self) -> int:
        """`<|nospeech|>` — always immediately below `<|notimestamps|>` in
        every released Whisper vocab (50362; large-v3 50363). Its
        probability at the SOT step is openai-whisper's silence signal."""
        return self.no_timestamps_token_id - 1

    @property
    def prev_sot_token_id(self) -> int:
        """`<|startofprev|>` — two below `<|notimestamps|>` in every
        released vocab (50361; large-v3 50362). Prefixes the previous-text
        context in conditioned decoding."""
        return self.no_timestamps_token_id - 2

    @property
    def num_audio_frames(self) -> int:
        """Mel frames fed to the encoder (30 s @ hop 160)."""
        return self.max_source_positions * 2

    def task_token_id(self, task: str) -> int:
        if task not in ("transcribe", "translate"):
            raise ValueError(f"unknown task {task!r} (transcribe|translate)")
        return (self.transcribe_token_id if task == "transcribe"
                else self.translate_token_id)

    def lang_token_id(self, language: str) -> int:
        code = LANGUAGE_CODES.get(language, language)
        return self.lang_token_offset + WHISPER_LANGUAGES.index(code)

    def prompt_ids(self, language: str, task: str = "transcribe",
                   no_timestamps: bool = True) -> list[int]:
        """Decoder prompt `<|sot|><|lang|><|task|>[<|notimestamps|>]`.

        The reference clears forced_decoder_ids/suppress_tokens and lets the
        processor supply these (reference src/models/base.py:129-131);
        here they are explicit and static.
        """
        ids = [self.sot_token_id, self.lang_token_id(language), self.task_token_id(task)]
        if no_timestamps:
            ids.append(self.no_timestamps_token_id)
        return ids

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "WhisperConfig":
        return WhisperConfig(**json.loads(s))

    def save(self, path: str | Path) -> None:
        Path(path).write_text(self.to_json())

    @staticmethod
    def load(path: str | Path) -> "WhisperConfig":
        return WhisperConfig.from_json(Path(path).read_text())


def _cfg(name, d, layers, heads, mels=80, vocab=51865, **kw):
    return WhisperConfig(
        name=name, vocab_size=vocab, num_mel_bins=mels, d_model=d,
        encoder_layers=layers, encoder_heads=heads,
        decoder_layers=layers, decoder_heads=heads, ffn_dim=4 * d, **kw)


# Registry: short name -> architecture. Parity with MODEL_NAME_MAP
# (reference src/models/base.py:16-24); `whisper-large` means large-v3
# there, so it does here too (128 mel bins, 51866 vocab, shifted task tokens).
MODEL_CONFIGS: dict[str, WhisperConfig] = {
    "whisper-tiny": _cfg("whisper-tiny", 384, 4, 6),
    "whisper-base": _cfg("whisper-base", 512, 6, 8),
    "whisper-small": _cfg("whisper-small", 768, 12, 12),
    "whisper-medium": _cfg("whisper-medium", 1024, 24, 16),
    "whisper-large": _cfg(
        "whisper-large", 1280, 32, 20, mels=128, vocab=51866,
        translate_token_id=50359, transcribe_token_id=50360,
        no_timestamps_token_id=50364),
    # Decoder-light variants (not in the reference's registry — it predates
    # them): turbo = large-v3 encoder + 4-layer decoder (openai), distil =
    # + 2-layer decoder (distil-whisper). Decode cost scales with decoder
    # layers, so these are the serving-throughput configs.
    "whisper-large-turbo": WhisperConfig(
        name="whisper-large-turbo", vocab_size=51866, num_mel_bins=128,
        d_model=1280, encoder_layers=32, encoder_heads=20,
        decoder_layers=4, decoder_heads=20, ffn_dim=5120,
        translate_token_id=50359, transcribe_token_id=50360,
        no_timestamps_token_id=50364),
    "distil-large-v3": WhisperConfig(
        name="distil-large-v3", vocab_size=51866, num_mel_bins=128,
        d_model=1280, encoder_layers=32, encoder_heads=20,
        decoder_layers=2, decoder_heads=20, ffn_dim=5120,
        translate_token_id=50359, transcribe_token_id=50360,
        no_timestamps_token_id=50364),
    # Tiny random-weight config for tests (no network, CPU-friendly).
    "whisper-test": WhisperConfig(
        name="whisper-test", vocab_size=256, num_mel_bins=80, d_model=64,
        encoder_layers=2, encoder_heads=4, decoder_layers=2, decoder_heads=4,
        ffn_dim=128, max_source_positions=32, max_target_positions=32,
        eos_token_id=3, sot_token_id=4, lang_token_offset=5,
        translate_token_id=104, transcribe_token_id=105,
        no_timestamps_token_id=106, pad_token_id=3),
}

# HF hub ids, for the weight converter (parity with
# reference src/models/base.py:16-24).
HF_MODEL_IDS = {
    "whisper-tiny": "openai/whisper-tiny",
    "whisper-base": "openai/whisper-base",
    "whisper-small": "openai/whisper-small",
    "whisper-medium": "openai/whisper-medium",
    "whisper-large": "openai/whisper-large-v3",
    "whisper-large-turbo": "openai/whisper-large-v3-turbo",
    "distil-large-v3": "distil-whisper/distil-large-v3",
}

# Language name -> ISO code (parity with
# reference src/models/base.py:27-36).
LANGUAGE_CODES = {
    "hindi": "hi",
    "italian": "it",
    "punjabi": "pa",
    "telugu": "te",
    "english": "en",
    "german": "de",
    "french": "fr",
    "spanish": "es",
}

# The four target languages of the reference pipeline
# (reference scripts/train_lora.py:48).
TARGET_LANGUAGES = ["hindi", "italian", "punjabi", "telugu"]

# Canonical Whisper language order: `<|xx|>` token id = lang_token_offset +
# index in this list (OpenAI tokenizer order; large-v3 appends "yue").
WHISPER_LANGUAGES = [
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
    "ba", "jw", "su", "yue",
]


def get_config(name: str) -> WhisperConfig:
    """Look up a model config by short name (e.g. "whisper-small")."""
    if name not in MODEL_CONFIGS:
        raise ValueError(f"Unknown model {name!r}; choices: {sorted(MODEL_CONFIGS)}")
    return MODEL_CONFIGS[name]


def get_model_info(name: str) -> dict:
    """Architecture summary; parity with get_model_info()
    (reference src/models/base.py:142-166)."""
    c = get_config(name)
    return {
        "model_name": name,
        "d_model": c.d_model,
        "encoder_layers": c.encoder_layers,
        "decoder_layers": c.decoder_layers,
        "encoder_attention_heads": c.encoder_heads,
        "decoder_attention_heads": c.decoder_heads,
        "encoder_ffn_dim": c.ffn_dim,
        "decoder_ffn_dim": c.ffn_dim,
        "vocab_size": c.vocab_size,
        "num_mel_bins": c.num_mel_bins,
        "max_source_positions": c.max_source_positions,
        "max_target_positions": c.max_target_positions,
    }
