"""AdapterRouter: routed multi-adapter transcription on one device
(counterpart of sar_tpu/models/router.py).

A batch of utterances in mixed languages goes through the LID classifier
at its tap layer; each utterance then takes its language's adapter from
the stacked bank in ONE batched pass: the adapted encoder, the cache and
the greedy decode with per-row prompts. `generate` decodes as the JAX
`generate` does, with `greedy_decode`'s default, the unquantized classic
cache (plain torch). `cache` / `decode` / `decode_from_cache` /
`step`, the program the service runs, build and read the int8
head-minor cache (its cross_v term through kernel K4, the bank slices
gathered once per batch; K3 in every step), as the JAX service's routed
program does; or, with `kv_int4`, the int4 classic one. They go through
the router's `DecodeRunner` (decode/graphs.py): the cache is its static
one, and each segment of the routed greedy loop is a CUDA graph captured
once per shape and replayed per batch, with the batch's `adapter_idx`
copied into the runner's static [B] buffer first. `capture` chooses as in
ASREvaluator: None captures on a CUDA device with the kernels and runs
eagerly otherwise, True on the CPU raises, False runs eagerly.

The router runs on the CUDA card unless `device` says otherwise (see
sar_tpu_torch/device.py); base, bank and classifier params are moved to
its device once. `flash` defaults to the attention kernel ("hm") on the
card and exact attention on the CPU; "fq" passes through to `encode`,
which keeps "hm" for a bank that adapts q/k/v (the usual q_proj/v_proj
bank) and for the LID tap.

While a profiler is active, `route` and `encode` are spans
(utils/profiling.py), beside the runner's `prep` and `decode`.

Teacher-forced `forward` takes the JAX router's three strategies: "hard"
(each row through its LID-chosen adapter), "soft" (every adapter on the
whole batch, the logits weighted by the LID probabilities and the loss
sum_i mean(p_i) * loss_i) and "threshold" (hard when every row's top
probability clears `threshold`, else soft). Its teacher-forced passes are
`whisper.forward`, with the blockwise attention K6 on the card (exact
attention on the CPU); they keep autograd, as a training-style forward.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from sar_tpu_torch.decode.graphs import (CudaGraphCapture, DecodeRunner,
                                         resolve_capture)
from sar_tpu_torch.device import resolve_device, tree_to
from sar_tpu_torch.models import classifier as clf
from sar_tpu_torch.models import lora as lora_lib
from sar_tpu_torch.models import whisper
from sar_tpu_torch.models.config import WhisperConfig
from sar_tpu_torch.utils import profiling


class AdapterRouter:
    """Frozen base + LID classifier + stacked adapter bank."""

    def __init__(self, cfg: WhisperConfig, base_params: dict, bank: dict,
                 lora_cfg: lora_lib.LoraConfig, clf_params: dict,
                 clf_cfg: clf.ClassifierConfig, strategy: str = "hard",
                 threshold: float = 0.7, flash: bool | str | None = None,
                 device: torch.device | str | None = None,
                 kernels: bool = True, capture: bool | None = None):
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
        self.capture = resolve_capture(capture, self.device, kernels)
        self.runner = DecodeRunner(self.base_params, cfg, lora=self._bank,
                                   lora_scale=lora_cfg.scale, kernels=kernels,
                                   capture=CudaGraphCapture if self.capture else None)

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
        with torch.no_grad(), profiling.span("route"):
            feats = self.extract_encoder_features(input_features)
            return clf.predict(self.clf_params, self.clf_cfg, feats)

    # -- Teacher-forced routing (training) -----------------------------------
    def forward(self, input_features: torch.Tensor,
                labels: torch.Tensor | None = None,
                strategy: str | None = None) -> dict:
        """LID, then the strategy's teacher-forced pass -> {"probs",
        "adapter_idx", and "logits" [B, T, V] fp32 and "loss" with labels,
        else (hard) "encoder_out"}; threshold with labels adds
        "confident"."""
        strategy = strategy or self.strategy
        mel = input_features.to(self.device, self.dtype)
        if labels is not None:
            labels = torch.as_tensor(labels, device=self.device).long()
        idx, probs = clf.predict(self.clf_params, self.clf_cfg,
                                 self.extract_encoder_features(mel))
        if strategy == "hard":
            return self._hard(mel, idx, probs, labels)
        if strategy == "soft":
            return self._soft(mel, probs, labels)
        if strategy == "threshold":
            return self._threshold(mel, idx, probs, labels)
        raise ValueError(f"Unknown routing strategy: {strategy}")

    def _threshold(self, mel, idx, probs, labels):
        """Hard when every row clears the threshold, else soft. Without
        labels the flag decides which output comes back (soft then raises);
        with labels both give the same keys plus the `confident` flag."""
        confident = (probs.max(-1).values > self.threshold).all()
        if labels is None:
            if bool(confident):
                return self._hard(mel, idx, probs, labels)
            return self._soft(mel, probs, labels)
        logits, loss = (self._hard_terms(mel, idx, labels) if bool(confident)
                        else self._soft_terms(mel, probs, labels))
        return {"loss": loss, "logits": logits, "probs": probs,
                "adapter_idx": idx, "confident": confident}

    def _teacher_logits(self, mel, labels, adapter_idx):
        dec_in = whisper.shift_tokens_right(labels, self.cfg.sot_token_id,
                                            self.cfg.pad_token_id)
        return whisper.forward(self.base_params, mel, dec_in,
                               self.cfg, lora=self._bank,
                               adapter_idx=adapter_idx,
                               lora_scale=self.lora_cfg.scale,
                               flash=self.device.type == "cuda")

    def _hard_terms(self, mel, adapter_idx, labels):
        logits = self._teacher_logits(mel, labels, adapter_idx)
        return logits, whisper.cross_entropy_loss(logits, labels)

    def _hard(self, mel, adapter_idx, probs, labels):
        out = {"probs": probs, "adapter_idx": adapter_idx}
        if labels is not None:
            out["logits"], out["loss"] = self._hard_terms(mel, adapter_idx, labels)
        else:
            out["encoder_out"] = self.encode(mel, adapter_idx)
        return out

    def _soft_terms(self, mel, probs, labels):
        """Every adapter on the full batch: (probability-weighted logits,
        sum_i mean(p_i) * loss_i)."""
        B = mel.shape[0]
        weighted, loss = None, 0.0
        for i in range(len(self.languages)):
            idx = torch.full((B,), i, dtype=torch.int64, device=self.device)
            logits = self._teacher_logits(mel, labels, idx)
            w = probs[:, i][:, None, None]
            weighted = w * logits if weighted is None else weighted + w * logits
            loss = loss + probs[:, i].mean() * whisper.cross_entropy_loss(logits, labels)
        return weighted, loss

    def _soft(self, mel, probs, labels):
        if labels is None:
            raise ValueError("soft routing requires labels (teacher-forced)")
        weighted, loss = self._soft_terms(mel, probs, labels)
        return {"loss": loss, "logits": weighted, "probs": probs}

    # -- Routed generation ----------------------------------------------------
    @torch.no_grad()
    def encode(self, input_features: torch.Tensor,
               adapter_idx: torch.Tensor) -> torch.Tensor:
        """The adapted encoder, adapter `adapter_idx[b]` for row b."""
        with profiling.span("encode"):
            return whisper.encode(self.base_params, input_features.to(self.device),
                                  self.cfg, lora=self._bank,
                                  adapter_idx=adapter_idx,
                                  lora_scale=self.lora_cfg.scale, flash=self.flash)

    @torch.no_grad()
    def cache(self, enc: torch.Tensor, adapter_idx: torch.Tensor,
              max_new_tokens: int = 256, kv_int4: bool = False,
              kv_int8: bool = True) -> whisper.DecodeCache:
        """The int8 head-minor cache of the adapted encoder output, with
        each row's cross_v adapter (kernel K4); with `kv_int4`, the int4
        classic one, and with neither flag the unquantized classic one
        (plain torch projections). Written into the runner's static cache
        (the previous batch's)."""
        total = min(self.prompt_len + max_new_tokens,
                    self.cfg.max_target_positions)
        int8 = kv_int8 and not kv_int4
        return self.runner.prep(enc, total, adapter_idx=adapter_idx,
                                cross_kv_int8=int8, self_kv_int8=int8,
                                cross_kv_int4=kv_int4, self_kv_int4=kv_int4)

    def decode_from_cache(self, cache: whisper.DecodeCache,
                          adapter_idx: torch.Tensor) -> torch.Tensor:
        """The routed greedy loop over the cache `cache` returned, each row
        with its adapter and its language's prompt."""
        return self.runner.greedy(cache, self._prompts[adapter_idx],
                                  adapter_idx=adapter_idx)

    def decode(self, enc: torch.Tensor, adapter_idx: torch.Tensor,
               max_new_tokens: int = 256, kv_int4: bool = False,
               kv_int8: bool = True) -> torch.Tensor:
        """Routed greedy decode: `cache`, then `decode_from_cache`."""
        return self.decode_from_cache(
            self.cache(enc, adapter_idx, max_new_tokens, kv_int4, kv_int8),
            adapter_idx)

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
        JAX `generate`, through the runner. `language` forces one adapter
        for every row; `adapter_idx` gives each row's adapter (skipping
        LID); otherwise LID picks them."""
        B = input_features.shape[0]
        if language is not None:
            idx = torch.full((B,), self.lang_to_idx[language],
                             dtype=torch.int64, device=self.device)
        elif adapter_idx is not None:
            idx = torch.as_tensor(adapter_idx, device=self.device).long()
        else:
            idx, _ = self.route(input_features)
        return self.decode(self.encode(input_features, idx), idx,
                           max_new_tokens, kv_int8=False)

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
