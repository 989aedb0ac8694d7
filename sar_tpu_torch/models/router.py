"""AdapterRouter: routed multi-adapter transcription on one device
(counterpart of sar_tpu/models/router.py, hard routing).

A batch of utterances in mixed languages goes through the LID classifier
at its tap layer; each utterance then takes its language's adapter from
the stacked bank in ONE batched pass: the adapted encoder, the cache and
the greedy decode with per-row prompts. `generate` decodes as the JAX
`generate` does, with `greedy_decode`'s default, the unquantized classic
cache (plain torch). `cache` / `decode` / `decode_from_cache` /
`step`, the program the service runs, build and read the int8
head-minor cache (its cross_v term through kernel K4, the bank slices
gathered once per batch; K3 in every step), as the JAX service's routed
program does; or, with `kv_int4`, the int4 classic one.

The router runs on the CUDA card unless `device` says otherwise (see
sar_tpu_torch/device.py); base, bank and classifier params are moved to
its device once. `flash` defaults to the attention kernel ("hm") on the
card and exact attention on the CPU; "fq" passes through to `encode`,
which keeps "hm" for a bank that adapts q/k/v (the usual q_proj/v_proj
bank) and for the LID tap. Teacher-forced `forward` (the hard, soft and
threshold strategies) is not ported yet and raises NotImplementedError.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from sar_tpu_torch.decode.greedy import greedy_decode, greedy_decode_from_cache
from sar_tpu_torch.device import resolve_device, tree_to
from sar_tpu_torch.models import classifier as clf
from sar_tpu_torch.models import lora as lora_lib
from sar_tpu_torch.models import whisper
from sar_tpu_torch.models.config import WhisperConfig


class AdapterRouter:
    """Frozen base + LID classifier + stacked adapter bank."""

    def __init__(self, cfg: WhisperConfig, base_params: dict, bank: dict,
                 lora_cfg: lora_lib.LoraConfig, clf_params: dict,
                 clf_cfg: clf.ClassifierConfig, strategy: str = "hard",
                 threshold: float = 0.7, flash: bool | str | None = None,
                 device: torch.device | str | None = None,
                 kernels: bool = True):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.base_params = tree_to(base_params, self.device)
        self.bank = tree_to(bank, self.device)
        self.lora_cfg = lora_cfg
        self.clf_params = tree_to(clf_params, self.device)
        self.clf_cfg = clf_cfg
        self.strategy = strategy
        self.threshold = threshold
        self.kernels = kernels
        self.flash = (("hm" if self.device.type == "cuda" else False)
                      if flash is None else flash)
        self.dtype = self.base_params["encoder"]["conv1"]["w"].dtype
        # The bank in the compute dtype, once: lora_delta casts to it anyway.
        self._bank = tree_to(self.bank, dtype=self.dtype)
        self.languages = list(clf_cfg.languages)
        self.lang_to_idx = {l: i for i, l in enumerate(self.languages)}
        # Per-language decoder prompts [A, P], gathered per row.
        self._prompts = torch.tensor(
            [cfg.prompt_ids(l) for l in self.languages], dtype=torch.int64,
            device=self.device)

    @property
    def prompt_len(self) -> int:
        return int(self._prompts.shape[1])

    # -- LID ---------------------------------------------------------------
    def extract_encoder_features(self, input_features: torch.Tensor) -> torch.Tensor:
        """Frozen base-encoder features at the classifier's tap layer."""
        return clf.encode_features(self.base_params,
                                   input_features.to(self.device), self.cfg,
                                   layer_index=self.clf_cfg.encoder_layer,
                                   flash=self.flash)

    @torch.no_grad()
    def detect_language(self, encoder_hidden_states
                        ) -> tuple[list[str], torch.Tensor]:
        """(language names, probs [B, A])."""
        idx, probs = clf.predict(self.clf_params, self.clf_cfg,
                                 encoder_hidden_states)
        return [self.languages[int(i)] for i in idx.tolist()], probs

    def route(self, input_features: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """LID: (adapter_idx [B] int64, probs [B, A])."""
        with torch.no_grad():
            feats = self.extract_encoder_features(input_features)
            return clf.predict(self.clf_params, self.clf_cfg, feats)

    # -- Teacher-forced routing (training) -----------------------------------
    def forward(self, input_features, labels=None, strategy=None):
        raise NotImplementedError(
            "AdapterRouter.forward: the teacher-forced hard, soft and "
            "threshold routing strategies are not ported yet")

    # -- Routed generation ----------------------------------------------------
    @torch.no_grad()
    def encode(self, input_features: torch.Tensor,
               adapter_idx: torch.Tensor) -> torch.Tensor:
        """The adapted encoder, adapter `adapter_idx[b]` for row b."""
        return whisper.encode(self.base_params, input_features.to(self.device),
                              self.cfg, lora=self._bank,
                              adapter_idx=adapter_idx,
                              lora_scale=self.lora_cfg.scale, flash=self.flash)

    @torch.no_grad()
    def cache(self, enc: torch.Tensor, adapter_idx: torch.Tensor,
              max_new_tokens: int = 256,
              kv_int4: bool = False) -> whisper.DecodeCache:
        """The int8 head-minor cache of the adapted encoder output, with
        each row's cross_v adapter (kernel K4); or, with `kv_int4`, the
        int4 classic one (plain torch projections)."""
        total = min(self.prompt_len + max_new_tokens,
                    self.cfg.max_target_positions)
        return whisper.init_cache(self.base_params, enc, self.cfg, total,
                                  lora=self._bank, adapter_idx=adapter_idx,
                                  lora_scale=self.lora_cfg.scale,
                                  cross_kv_int8=not kv_int4,
                                  self_kv_int8=not kv_int4,
                                  cross_kv_int4=kv_int4, self_kv_int4=kv_int4,
                                  kernels=self.kernels)

    def decode_from_cache(self, cache: whisper.DecodeCache,
                          adapter_idx: torch.Tensor) -> torch.Tensor:
        """The routed greedy loop over a prepared cache, each row with its
        adapter and its language's prompt."""
        return greedy_decode_from_cache(
            self.base_params, cache, self.cfg, self._prompts[adapter_idx],
            lora=self._bank, adapter_idx=adapter_idx,
            lora_scale=self.lora_cfg.scale, kernels=self.kernels)

    def decode(self, enc: torch.Tensor, adapter_idx: torch.Tensor,
               max_new_tokens: int = 256, kv_int4: bool = False) -> torch.Tensor:
        """Routed greedy decode: `cache`, then `decode_from_cache`."""
        return self.decode_from_cache(
            self.cache(enc, adapter_idx, max_new_tokens, kv_int4), adapter_idx)

    @torch.no_grad()
    def step(self, tokens: torch.Tensor, pos: int, cache: whisper.DecodeCache,
             adapter_idx: torch.Tensor) -> tuple[torch.Tensor, whisper.DecodeCache]:
        """One routed decode step (whisper.decode_step with the bank)."""
        return whisper.decode_step(self.base_params, tokens, pos, cache,
                                   self.cfg, lora=self._bank,
                                   adapter_idx=adapter_idx,
                                   lora_scale=self.lora_cfg.scale,
                                   kernels=self.kernels)

    @torch.no_grad()
    def generate(self, input_features: torch.Tensor,
                 language: str | None = None, adapter_idx=None,
                 max_new_tokens: int = 256) -> torch.Tensor:
        """Batched routed transcription -> tokens [B, P + max_new_tokens],
        greedy over `greedy_decode`'s default (unquantized) cache, as the
        JAX `generate`. `language` forces one adapter for every row;
        `adapter_idx` gives each row's adapter (skipping LID); otherwise
        LID picks them."""
        B = input_features.shape[0]
        if language is not None:
            idx = torch.full((B,), self.lang_to_idx[language],
                             dtype=torch.int64, device=self.device)
        elif adapter_idx is not None:
            idx = torch.as_tensor(adapter_idx, device=self.device).long()
        else:
            idx, _ = self.route(input_features)
        return greedy_decode(self.base_params, self.encode(input_features, idx),
                             self.cfg, self._prompts[idx],
                             max_new_tokens=max_new_tokens, lora=self._bank,
                             adapter_idx=idx, lora_scale=self.lora_cfg.scale,
                             kernels=self.kernels)

    # -- Persistence ---------------------------------------------------------
    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        lora_lib.save_adapter(path / "bank", self.bank, self.lora_cfg,
                              metadata={"languages": self.languages})
        clf.save_classifier(path / "classifier", self.clf_params, self.clf_cfg)
        (path / "router_config.json").write_text(json.dumps({
            "model": self.cfg.name, "strategy": self.strategy,
            "threshold": self.threshold}, indent=2))

    @staticmethod
    def load(path: str | Path, cfg: WhisperConfig, base_params: dict,
             **router_kw) -> "AdapterRouter":
        path = Path(path)
        rc = json.loads((path / "router_config.json").read_text())
        bank, lora_cfg, _ = lora_lib.load_adapter(path / "bank")
        clf_params, clf_cfg, _ = clf.load_classifier(path / "classifier")
        return AdapterRouter(cfg, base_params, bank, lora_cfg, clf_params,
                             clf_cfg, strategy=rc["strategy"],
                             threshold=rc["threshold"], **router_kw)


def build_router_from_checkpoints(
        cfg: WhisperConfig, base_params: dict, adapter_dirs: dict[str, str],
        clf_params: dict, clf_cfg: clf.ClassifierConfig,
        strategy: str = "hard", threshold: float = 0.7,
        **router_kw) -> AdapterRouter:
    """A router from per-language adapter directories (sar_tpu,
    sar_tpu_torch or PEFT), stacked in the classifier's language order,
    mixed ranks allowed. Each adapter's own alpha/r is folded into its B,
    so the bank's scale is 1.0."""
    adapters = []
    for lang in clf_cfg.languages:
        bank, lcfg, _ = lora_lib.load_any_adapter(adapter_dirs[lang], cfg)
        if lora_lib.num_adapters(bank) != 1:
            raise ValueError(f"{adapter_dirs[lang]} holds a bank, not a single adapter")
        adapters.append(lora_lib.map_with_path(
            lambda p, x, s=lcfg.scale: x * s if p[-1] == "b" else x, bank))
    stacked = lora_lib.stack_adapters(adapters)
    r = lora_lib.rank(stacked)
    lora_cfg = lora_lib.LoraConfig(r=r, alpha=r, dropout=0.0)
    return AdapterRouter(cfg, base_params, stacked, lora_cfg, clf_params,
                         clf_cfg, strategy=strategy, threshold=threshold,
                         **router_kw)
