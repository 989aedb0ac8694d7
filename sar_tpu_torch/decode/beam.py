"""Batched beam search (counterpart of sar_tpu/decode/beam.py).

The algorithm of transformers' `_beam_search`, as the JAX package runs it:
beam width K, 2K candidates per step, separate running and finished sets
merged by top-k, and the early-stopping heuristic of early_stopping=False.
The JAX package runs it as one `lax.while_loop`; here it is a host loop
over positions with one sync per step (whether any sample can still
improve), as the port's greedy loop.

Semantics kept from the reference:
- running scores start at 0 for beam 0 and -1e9 for the others (identical
  beams are not expanded twice);
- per step, the top 2K candidates by accumulated log-prob, in two exact
  stages (top 2K per beam on the raw logits, then top 2K of the K*2K
  survivors, converted to log-probs by the row logsumexp); candidates that
  hit EOS or the full buffer leave the running set, and only those ranked
  below K may finalize;
- a finished score is the summed log-prob (EOS included) over
  gen_len ** length_penalty, gen_len counting the EOS;
- a sample stops improving once its best running beam, ended at the
  current length, cannot beat its worst finished slot;
- suppress masks act on the log-probs, without renormalizing;
- the prompt is forced token by token, beams kept in place.

`lax.top_k` puts the lower index first among equal values; `torch.topk`
promises no order, so the stages that can tie (the running set, where
stopped candidates all sit near -1e9, and the finished merge) sort with a
stable descending sort instead.

The cache is the JAX package's default, the unquantized classic one,
unless the int8 or int4 flags ask for another (see `beam_decode`).
Cross K/V are ONE copy per sample, shared by its K beams: `decode_step`
folds the beam queries into one cross-attention call (kernel K5 over the
int8 cache, plain attention over the classic one). The
self cache holds B*K slots that are never moved: an ancestry matrix
anc[b, k, t] (the slot that wrote row t of beam k's history) is composed
per step with `torch.gather` instead of reordering the cache. The int4
cache and `scores_int8` (kernel K7) keep the JAX package's physical
reorder instead: after each step the self cache and its scales are
gathered by the surviving beams' sources, within each sample (the cross
slabs stay one per sample). The self cache is allocated at the full length
`total`; the JAX package's `segment` only shortens its buffers and gives
the same tokens, so the argument is accepted and changes nothing.
`timestamps=True` is not ported and raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sar_tpu_torch.models import whisper
from sar_tpu_torch.models.config import WhisperConfig

NEG_INF = -1e9


class BeamState(NamedTuple):
    """The search state of B samples x K beams (all on one device)."""
    run_seqs: torch.Tensor    # [B, K, total] int64
    run_scores: torch.Tensor  # [B, K] fp32 summed log-probs
    fin_seqs: torch.Tensor    # [B, K, total] int64
    fin_scores: torch.Tensor  # [B, K] fp32, length-normalized, descending
    fin_flags: torch.Tensor   # [B, K] bool, slot holds a finished hypothesis
    unsat: torch.Tensor       # [B] bool, the sample can still improve
    anc: torch.Tensor         # [B, K, total] int64 ancestry (slot of row t)


def init_state(prompt: torch.Tensor, num_beams: int, total: int,
               eos: int) -> BeamState:
    """The state before position 0: every beam holds the prompt [B, P]."""
    B, P = prompt.shape
    K, dev = num_beams, prompt.device
    run_seqs = torch.full((B, K, total), eos, dtype=torch.int64, device=dev)
    run_seqs[:, :, :P] = prompt[:, None, :]
    run_scores = torch.full((B, K), NEG_INF, device=dev)
    run_scores[:, 0] = 0.0
    slots = torch.arange(K, device=dev)
    return BeamState(
        run_seqs=run_seqs, run_scores=run_scores, fin_seqs=run_seqs.clone(),
        fin_scores=torch.full((B, K), NEG_INF, device=dev),
        fin_flags=torch.zeros((B, K), dtype=torch.bool, device=dev),
        unsat=torch.ones(B, dtype=torch.bool, device=dev),
        anc=slots[None, :, None].expand(B, K, total).clone())


def _top(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k` on the last axis: the k largest, descending, the lower
    index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, T], idx [B, M] -> x[b, idx[b, m]] as [B, M, T]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def beam_select(state: BeamState, logits: torch.Tensor, pos: int,
                prompt_len: int, *, length_penalty: float = 1.0, eos: int,
                suppress: torch.Tensor | None = None,
                begin_suppress: torch.Tensor | None = None) -> BeamState:
    """Everything of one step after the logits: logits [B*K, V] at
    position `pos` -> the state after writing position pos + 1."""
    B, K, total = state.run_seqs.shape
    K2 = 2 * K
    P = prompt_len
    if pos + 1 < P:
        # Prompt phase: every beam already holds the next prompt token
        # (init_state); beams, scores and the finished set stay as they are.
        return state
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)                        # [B*K]
    sel = logits32
    if suppress is not None or (begin_suppress is not None and pos == P - 1):
        sel = sel.clone()
        if suppress is not None:
            sel[:, suppress] = NEG_INF
        if begin_suppress is not None and pos == P - 1:
            sel[:, begin_suppress] = NEG_INF
    vals, toks = torch.topk(sel, K2, dim=-1)                       # [B*K, 2K]
    logp2k = vals - lse[:, None]
    acc = (state.run_scores.reshape(B * K)[:, None] + logp2k).reshape(B, K * K2)
    scores2k, col2k = _top(acc, K2)                                # [B, 2K]
    beam_src = torch.div(col2k, K2, rounding_mode="floor")
    tok2k = torch.gather(toks.reshape(B, K * K2), 1, col2k)
    cand_seqs = _gather_rows(state.run_seqs, beam_src)
    cand_seqs[:, :, pos + 1] = tok2k

    # Stopping criteria per candidate: EOS, or the buffer is now full.
    hits = (tok2k == eos) | (pos + 2 >= total)
    run_cand = scores2k + hits * NEG_INF
    new_run_scores, rsel = _top(run_cand, K)                       # rsel in [0, 2K)
    new_run_seqs = _gather_rows(cand_seqs, rsel)
    alive_src = torch.gather(beam_src, 1, rsel)

    # Finished set: merge candidates that stopped (rank < K only), scored
    # with the length penalty over generated tokens including this one.
    # An fp32 scalar on the host (as the JAX package's fp32 power): dividing
    # a CUDA tensor by it needs no copy to the device and no sync.
    lp_norm = torch.tensor(float(max(pos + 2 - P, 1))).pow(length_penalty)
    norm = scores2k / lp_norm
    top_k_mask = torch.arange(K2, device=logits.device) < K
    can_finalize = hits & top_k_mask[None] & state.unsat[:, None]
    fin_cand = torch.where(can_finalize, norm, NEG_INF)
    merged_scores = torch.cat([state.fin_scores, fin_cand], dim=1)
    merged_seqs = torch.cat([state.fin_seqs, cand_seqs], dim=1)
    merged_flags = torch.cat([state.fin_flags, can_finalize], dim=1)
    new_fin_scores, fsel = _top(merged_scores, K)
    new_fin_seqs = _gather_rows(merged_seqs, fsel)
    new_fin_flags = torch.gather(merged_flags, 1, fsel)

    # New beam k's history is old beam alive_src[k]'s (the row written at
    # `pos` included: its slot is alive_src[k], column pos being the
    # identity before this gather).
    anc = _gather_rows(state.anc, alive_src)

    # early_stopping=False: can the best running beam, ended now, beat the
    # worst finished slot (-1e9 for open slots keeps the sample going)?
    best_possible = new_run_scores.max(dim=1).values / lp_norm
    worst = torch.where(new_fin_flags,
                        new_fin_scores.min(dim=1, keepdim=True).values,
                        NEG_INF)
    still = (best_possible[:, None] > worst).any(dim=1)
    return BeamState(run_seqs=new_run_seqs, run_scores=new_run_scores,
                     fin_seqs=new_fin_seqs, fin_scores=new_fin_scores,
                     fin_flags=new_fin_flags, unsat=state.unsat & still,
                     anc=anc)


def reorder_self_cache(cache: whisper.DecodeCache,
                       src: torch.Tensor) -> whisper.DecodeCache:
    """The physical reorder of the int4 and scores_int8 beams: the self
    cache and its scales gathered so that new beam k of sample b takes the
    rows of beam src[b, k] ([B, K], within the sample); the cross slabs,
    one per sample, stay."""
    B, K = src.shape
    rows = (torch.arange(B, device=src.device)[:, None] * K + src).reshape(-1)
    return cache._replace(**{
        f: getattr(cache, f).index_select(1, rows)
        for f in ("self_k", "self_v", "self_k_scale", "self_v_scale")})


@torch.no_grad()
def beam_decode(params: dict, enc_out: torch.Tensor, cfg: WhisperConfig,
                prompt_ids, *, num_beams: int = 4,
                max_new_tokens: int = 256, length_penalty: float = 1.0,
                lora: dict | None = None, adapter_idx=None,
                lora_scale: float = 1.0,
                cross_kv_int8: bool = False, self_kv_int8: bool = False,
                cross_kv_int4: bool = False, self_kv_int4: bool = False,
                scores_int8: bool = False,
                suppress_ids: tuple[int, ...] = (),
                begin_suppress_ids: tuple[int, ...] = (),
                segment: int = 32, timestamps: bool = False,
                head_minor: bool | None = None,
                kernels: bool = True) -> torch.Tensor:
    """Beam search over a cache built from `enc_out` [B, S, D]: the
    unquantized classic one by default, as in the JAX package (plain
    torch: the cross-attention folds each sample's beams into one plain
    attention call, the self cache is read through the ancestry); the int8
    head-minor one with cross_kv_int8 = self_kv_int8 = True (kernels K2 and
    K5); or the int4 classic one (cross_kv_int4 = self_kv_int4 = True).
    `head_minor` as `init_cache` takes it. prompt_ids: [P] or [B, P].
    Returns the best beam of each sample,
    [B, min(P + max_new_tokens, max_target_positions)] int64; positions
    after its EOS are EOS.

    `lora` (a bank) adapts the cache build and every step, with adapter 0
    for the batch or `adapter_idx` [B] per sample (repeated K times for the
    steps). `scores_int8` decodes with s8 scores (kernel K7). `kernels=False`
    runs the plain versions of the kernels on any device. `segment` changes
    no token (see the module docstring)."""
    del segment
    if timestamps:
        raise NotImplementedError("beam_decode(timestamps=True) is not ported")
    int4 = cross_kv_int4 or self_kv_int4
    B = enc_out.shape[0]
    K = num_beams
    dev = enc_out.device
    prompt = torch.as_tensor(prompt_ids, dtype=torch.int64, device=dev)
    if prompt.dim() == 1:
        prompt = prompt[None].expand(B, -1)
    P = prompt.shape[1]
    total = min(P + max_new_tokens, cfg.max_target_positions)
    eos = cfg.eos_token_id
    cache = whisper.init_cache(params, enc_out, cfg, max_len=total, lora=lora,
                               adapter_idx=adapter_idx, lora_scale=lora_scale,
                               cross_kv_int8=cross_kv_int8,
                               self_kv_int8=self_kv_int8,
                               cross_kv_int4=cross_kv_int4,
                               self_kv_int4=self_kv_int4, head_minor=head_minor,
                               self_batch=B * K, kernels=kernels)
    idx_k = (None if adapter_idx is None else
             torch.as_tensor(adapter_idx, device=dev).repeat_interleave(K))
    suppress = (torch.as_tensor(suppress_ids, dtype=torch.int64, device=dev)
                if suppress_ids else None)
    begin_suppress = (torch.as_tensor(begin_suppress_ids, dtype=torch.int64,
                                      device=dev)
                      if begin_suppress_ids else None)
    state = init_state(prompt, K, total, eos)
    slots = torch.arange(K, device=dev)
    use_anc = K > 1 and not (int4 or scores_int8)
    for pos in range(total - 1):
        if not bool(state.unsat.any()):
            break
        # This step writes each beam's row into its own slot: column `pos`
        # of the ancestry is the identity.
        state.anc[:, :, pos] = slots
        logits, cache = whisper.decode_step(
            params, state.run_seqs.reshape(B * K, total)[:, pos], pos, cache,
            cfg, lora=lora, adapter_idx=idx_k, lora_scale=lora_scale,
            scores_int8=scores_int8, beam_width=K,
            ancestry=state.anc if use_anc else None, kernels=kernels)
        state = beam_select(state, logits, pos, P,
                            length_penalty=length_penalty, eos=eos,
                            suppress=suppress, begin_suppress=begin_suppress)
        if K > 1 and not use_anc and pos + 1 >= P:
            # Physical reorder: after the selection, column `pos` of the
            # ancestry holds each new beam's source slot (alive_src).
            cache = reorder_self_cache(cache, state.anc[:, :, pos])
    # The finished slots stay sorted descending; slot 0 is the best (the
    # max-length finalization guarantees one exists).
    return state.fin_seqs[:, 0]
