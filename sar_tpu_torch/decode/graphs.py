"""Captured decode programs: the port's counterpart of `jax.jit` over the
decode loop.

The JAX package has no module of its own for this. Its entry points hold
the loop as jitted programs: `greedy_decode_jit` (sar_tpu/decode/greedy.py),
the evaluator's `_decode`, with the cache donated, and `_beam`
(sar_tpu/evaluation/evaluator.py), and the service's programs. Each is a
static-shape `lax.while_loop` per segment, with no round trip to the host
per token. PyTorch's counterpart of a jitted static-shape loop is a
captured CUDA graph.

A `DecodeRunner` belongs to an entry point that owns its parameters
(ASREvaluator, AdapterRouter, and through them TranscriptionService). It
keeps the decode cache as a static buffer (`prep`: `init_cache(out=)`, the
counterpart of JAX donating the cache) and, per key, a program: the
segments of the greedy or beam loop (`greedy_segment`, `beam_segment`)
over static buffers, each captured once as a CUDA graph and replayed for
every batch of that key. A key holds everything a graph bakes in: the
kind of program, the cache (its kind and shapes: batch, beam width, total
length), the prompt buffer's width, `scores_int8`, the suppress and
begin-suppress ids, `segment`, the LoRA bank (none, one adapter, or
routed `adapter_idx`) and its scale, the length penalty, the greedy
options that are on (sampling, logprobs, no-speech, timestamps and the
initial-timestamp index, a generation cap), and the identity of the
parameters and the bank: the runner never swaps its weights under a
graph. The values JAX traces stay out of the key: the forced-prefix
length, the temperature, the seed, the no-speech position and the cap
are device tensors that the runner refills per call, so one program
serves every window of a conditioned long-form run and every temperature
of a fallback ladder, as one JAX program does. A cache of another shape
drops the old cache and every program on it, so that no second full cache
stays alive.

Per batch the runner refills its static buffers in place (the tokens
[B, total] with the prompts, the finished flags or the beam state, the
routed `adapter_idx` [B], the greedy options' values and accumulators),
then runs the segments in order with one host sync after each
(decode/segments.py). The first batch to reach a segment
runs it eagerly, which leaves the one-time set-up (the kernels' build,
their `cudaFuncSetAttribute`, cuBLAS's handles and workspaces) outside the
capture and gives that batch its tokens, then captures it; later batches
replay it. All the graphs of a key share one private memory pool: they run
one after another. A failed capture or replay raises and drops the key's
program; nothing carries on eagerly. The prep (encoder + cache build)
stays eager, as JAX keeps it a program of its own.

The kernels' launch counters (`LAUNCHES`, ... in ops/*.py) and the step
counters (segments.STEPS) are Python integers that move only while a
graph is captured, not when it replays: the runner records each one's
change over the capture, puts it back, and adds the change on every
replay, so that the counts stay those of an eager run.

`CAPTURE` counts, for the whole process, the graphs captured, their nodes
and the seconds spent capturing and instantiating them. It moves only at a
capture, is always on, and stays out of that rollback. While a profiler is
active, the runner's `prep`, `greedy` and `beam` and each segment's run
and host sync are spans (utils/profiling.py: `prep`, `decode`,
`decode.segment`, `decode.sync`).

`CudaGraphCapture` is the one place that captures: the CPU tests give the
runner a stand-in with its two methods and check the bookkeeping (keys,
refills, counter replays); only the real capture needs the card.
"""

from __future__ import annotations

import ctypes
import time
from typing import Callable

import torch

from sar_tpu_torch.decode import segments
from sar_tpu_torch.decode.beam import beam_row_adapters, beam_segment, init_state
from sar_tpu_torch.decode.greedy import (extras_outputs, fill_extras,
                                         greedy_segment, make_extras)
from sar_tpu_torch.models import whisper
from sar_tpu_torch.models.config import WhisperConfig
from sar_tpu_torch.utils import profiling

# The process's CUDA-graph captures: graphs, their nodes, and the seconds of
# capture and instantiation (CudaGraphCapture.capture adds to it).
CAPTURE = {"graphs": 0, "nodes": 0, "seconds": 0.0}


def resolve_capture(capture: bool | None, device: torch.device,
                    kernels: bool = True) -> bool:
    """An entry point's `capture` argument: None is captured on a CUDA
    device and eager elsewhere, and eager with kernels=False (the plain
    path, the lockstep checks' yardstick); True on another device or with
    kernels=False raises."""
    if capture is None:
        return device.type == "cuda" and kernels
    if capture and device.type != "cuda":
        raise ValueError(f"capture=True needs a CUDA device, not {device}: "
                         f"a CUDA graph replays work on the card")
    if capture and not kernels:
        raise ValueError("capture=True with kernels=False: the plain path "
                         "runs eagerly")
    return bool(capture)


def _counters() -> list[tuple[dict, str]]:
    """Every (namespace, name) of an integer counter that a decode body
    moves in Python: the kernels' launch counters and the step counters."""
    from sar_tpu_torch.ops import decode_cross, flash, flash_enc, kv_init
    from sar_tpu_torch.ops.attic import attention, decode_self
    launches = {flash_enc: ("LAUNCHES", "FUSED_LAUNCHES"),
                kv_init: ("LAUNCHES", "LORA_LAUNCHES"),
                decode_cross: ("LAUNCHES", "BEAM_LAUNCHES", "S8_LAUNCHES",
                               "S8_BEAM_LAUNCHES"),
                flash: ("LAUNCHES", "DQ_LAUNCHES", "DKV_LAUNCHES"),
                decode_self: ("LAUNCHES",), attention: ("LAUNCHES",)}
    return ([(vars(m), n) for m, names in launches.items() for n in names]
            + [(segments.STEPS, k) for k in segments.STEPS])


def _read_counters() -> list[int]:
    return [ns[k] for ns, k in _counters()]


def _write_counters(values: list[int]) -> None:
    for (ns, k), v in zip(_counters(), values):
        ns[k] = v


class CudaGraphCapture:
    """The capture seam of one key: a side stream and a private memory
    pool shared by the key's graphs; `warm_up` runs a body eagerly on that
    stream, `capture` records it as a CUDA graph (capture_error_mode
    "thread_local": the service's worker captures while request threads
    run) and returns its replay. Counts its graphs, their nodes and the
    seconds spent capturing and instantiating."""

    def __init__(self):
        self.pool = None
        self.stream = None
        self.graphs: list = []
        self.nodes = 0
        self.seconds = 0.0

    def _ensure(self):
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream()

    def warm_up(self, body: Callable[[], None]) -> None:
        self._ensure()
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream):
            body()
        torch.cuda.current_stream().wait_stream(self.stream)

    def capture(self, body: Callable[[], None]) -> Callable[[], None]:
        self._ensure()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            body()
        graph.instantiate()
        torch.cuda.synchronize()
        seconds, nodes = time.perf_counter() - t0, graph_nodes(graph)
        self.seconds += seconds
        self.nodes += nodes
        self.graphs.append(graph)
        CAPTURE["graphs"] += 1
        CAPTURE["nodes"] += nodes
        CAPTURE["seconds"] += seconds
        return graph.replay


def graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The node count of a captured graph (kept with keep_graph=True), read
    through cuGraphGetNodes of libcuda."""
    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {err}")
    return n.value


class _Program:
    """The segments of one key over its static buffers `static`: run
    eagerly (no seam), or each warmed up, captured once and replayed;
    `done()` is the device flag the host reads after each segment."""

    def __init__(self, bodies: list[Callable[[], None]],
                 done: Callable[[], torch.Tensor], seam, static: tuple):
        self.bodies, self.done, self.seam = bodies, done, seam
        self.static = static
        self.replays: list = [None] * len(bodies)
        self.deltas: list = [None] * len(bodies)

    def run(self) -> None:
        """Run the segments in order until `done`."""
        for s, body in enumerate(self.bodies):
            with profiling.span("decode.segment"):
                if self.seam is None:
                    body()
                elif self.replays[s] is None:
                    self.seam.warm_up(body)
                    before = _read_counters()
                    try:
                        self.replays[s] = self.seam.capture(body)
                    finally:
                        after = _read_counters()
                        _write_counters(before)
                    self.deltas[s] = [a - b for a, b in zip(after, before)]
                else:
                    self.replays[s]()
                    _write_counters([c + d for c, d in zip(_read_counters(), self.deltas[s])])
            with profiling.span("decode.sync"):
                done = segments.host_flag(self.done())
            if done:
                return


class DecodeRunner:
    """The decode programs of one owner of `params` (and of a LoRA bank
    `lora` with `lora_scale`): its static cache, and per key a greedy or
    beam program over static buffers, captured when `capture` is given (a
    factory of capture seams, e.g. CudaGraphCapture; one seam per key),
    eager otherwise. See the module docstring. `tp` (the "model" group of
    a tensor-parallel shard `params`) decodes this rank's heads over a
    classic cache, eagerly: no machine at hand shows NCCL inside a
    captured graph, so a runner with `tp` takes no `capture`."""

    def __init__(self, params: dict, cfg: WhisperConfig, *,
                 lora: dict | None = None, lora_scale: float = 1.0,
                 kernels: bool = True, capture=None, tp=None):
        if tp is not None and capture is not None:
            raise ValueError("a DecodeRunner under tensor parallelism decodes "
                             "eagerly: its collectives are not captured")
        self.params, self.cfg = params, cfg
        self.lora, self.lora_scale = lora, lora_scale
        self.kernels = kernels
        self.capture = capture
        self.tp = tp
        self._cache: whisper.DecodeCache | None = None
        self._cache_key = None
        self._programs: dict = {}

    # -- the static cache ---------------------------------------------------
    @torch.no_grad()
    def prep(self, enc_out: torch.Tensor, total: int, *, adapter_idx=None,
             self_batch: int | None = None, **cache_flags) -> whisper.DecodeCache:
        """`whisper.init_cache` of `enc_out` written into the runner's static
        cache (allocated once per shape; a new shape drops the old cache
        and the programs on it first). `cache_flags` are init_cache's
        cross/self_kv_int8/int4 and head_minor."""
        B, S, _ = enc_out.shape
        kind = whisper.cache_kind(**cache_flags)
        key = (B, S, total, kind, self_batch, enc_out.dtype, enc_out.device)
        with profiling.span("prep"):
            if key != self._cache_key:
                self._programs.clear()
                self._cache = self._cache_key = None
                with torch.inference_mode(False):
                    self._cache = whisper.empty_cache(
                        self.cfg, B, S, total, kind=kind, self_batch=self_batch,
                        dtype=enc_out.dtype, device=enc_out.device,
                        heads=whisper.decoder_heads(self.params, self.cfg))
                self._cache_key = key
            return whisper.init_cache(self.params, enc_out, self.cfg, total,
                                      lora=self.lora, adapter_idx=adapter_idx,
                                      lora_scale=self.lora_scale,
                                      self_batch=self_batch, kernels=self.kernels,
                                      out=self._cache, tp=self.tp, **cache_flags)

    def _program(self, key, build) -> _Program:
        prog = self._programs.get(key)
        if prog is None:
            seam = None if self.capture is None else self.capture()
            with torch.inference_mode(False):
                prog = self._programs[key] = build(seam)
        return prog

    def _run(self, key, prog: _Program) -> None:
        try:
            prog.run()
        except BaseException:
            # A graph half captured (or a replay that failed) leaves the
            # key's buffers in no known state: the next batch starts anew.
            self._programs.pop(key, None)
            raise

    def _check_cache(self, cache: whisper.DecodeCache) -> None:
        if cache is not self._cache:
            raise ValueError("a runner decodes over its static cache: build "
                             "it with DecodeRunner.prep")

    def _key(self, kind: str, cache, **rest) -> tuple:
        return (kind, id(cache), tuple(cache.self_k.shape),
                tuple(cache.cross_k.shape), cache.cross_k.dtype,
                cache.cross_k.device, id(self.params), id(self.lora),
                self.lora_scale, *sorted(rest.items()))

    # -- programs -----------------------------------------------------------
    @torch.no_grad()
    def greedy(self, cache: whisper.DecodeCache, prompts, *, prompt_len=None,
               adapter_idx=None, scores_int8: bool = False,
               suppress_ids: tuple[int, ...] = (),
               begin_suppress_ids: tuple[int, ...] = (),
               segment: int = 32, timestamps: bool = False,
               max_initial_timestamp_index: int | None = 1,
               temperature: float = 0.0, seed: int | None = None,
               with_logprobs: bool = False, with_no_speech: bool = False,
               no_speech_pos: int = 0, max_gen_tokens: int | None = None):
        """The greedy loop over `cache` (the runner's static cache):
        greedy_decode_from_cache's outputs (copies), with `prompts` [P] or
        [B, P] and, for a routed bank, each row's `adapter_idx` [B]. The
        options are greedy_decode_from_cache's: which are on is part of
        the key; their values (prompt_len, temperature, seed,
        no_speech_pos, max_gen_tokens) are refilled per call, so one
        program serves every prefix length and temperature."""
        self._check_cache(cache)
        if seed is None and temperature != 0.0:
            raise ValueError("temperature > 0 requires a seed")
        B, total = cache.cross_k.shape[1], cache.self_k.shape[3]
        dev = cache.cross_k.device
        prompts = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
        P = prompts.shape[-1]
        routed = adapter_idx is not None
        flags = dict(sample=seed is not None, with_logprobs=with_logprobs,
                     with_no_speech=with_no_speech, cap=max_gen_tokens is not None)
        key = self._key("greedy", cache, P=P, routed=routed,
                        scores_int8=scores_int8,
                        suppress_ids=tuple(suppress_ids),
                        begin_suppress_ids=tuple(begin_suppress_ids),
                        segment=segment, timestamps=timestamps,
                        max_initial_timestamp_index=(
                            max_initial_timestamp_index if timestamps else None),
                        **flags)

        params, cfg, lora, scale, kernels, tp = (self.params, self.cfg, self.lora,
                                                 self.lora_scale, self.kernels, self.tp)

        def build(seam):
            # The bodies hold what they read, not the runner: no cycle keeps
            # a dropped runner's cache and graphs alive.
            tokens = torch.empty((B, total), dtype=torch.int64, device=dev)
            finished = torch.empty(B, dtype=torch.bool, device=dev)
            idx = torch.empty(B, dtype=torch.int64, device=dev) if routed else None
            ex = make_extras(B, dev, **flags)
            suppress, begin = (
                torch.tensor(ids, dtype=torch.int64, device=dev) if ids else None
                for ids in (suppress_ids, begin_suppress_ids))

            def body(lo, hi, n):
                return lambda: greedy_segment(
                    params, cache, cfg, tokens, finished, lo, hi, n, ex, lora=lora,
                    adapter_idx=idx, lora_scale=scale, scores_int8=scores_int8,
                    suppress=suppress, begin_suppress=begin, timestamps=timestamps,
                    max_initial_timestamp_index=max_initial_timestamp_index,
                    prompt_width=P, kernels=kernels, tp=tp)

            return _Program([body(*g) for g in segments.grid(total, segment)],
                            finished.all, seam, (tokens, finished, idx, ex))

        with profiling.span("decode"):
            prog = self._program(key, build)
            tokens, finished, idx, ex = prog.static
            tokens.fill_(self.cfg.eos_token_id)
            tokens[:, :P] = prompts
            finished.zero_()
            fill_extras(ex, plen=P if prompt_len is None else prompt_len,
                        temperature=temperature, seed=seed or 0,
                        no_speech_pos=no_speech_pos, max_gen_tokens=max_gen_tokens)
            if routed:
                idx.copy_(torch.as_tensor(adapter_idx, device=dev))
            self._run(key, prog)
            out = extras_outputs(tokens, ex)
            return (tuple(x.clone() for x in out) if isinstance(out, tuple)
                    else out.clone())

    @torch.no_grad()
    def beam(self, cache: whisper.DecodeCache, prompts, *, num_beams: int,
             length_penalty: float = 1.0, adapter_idx=None,
             scores_int8: bool = False, suppress_ids: tuple[int, ...] = (),
             begin_suppress_ids: tuple[int, ...] = (),
             segment: int = 32, timestamps: bool = False,
             max_initial_timestamp_index: int | None = 1) -> torch.Tensor:
        """Beam search over `cache` (one cross slab per sample, B*K self
        rows): beam_decode's best beam per sample [B, total] (a copy)."""
        self._check_cache(cache)
        K = num_beams
        B, total = cache.cross_k.shape[1], cache.self_k.shape[3]
        if cache.self_k.shape[1] != B * K:
            raise ValueError(f"a beam search of {K} needs {B * K} self-cache "
                             f"rows, not {cache.self_k.shape[1]}")
        dev = cache.cross_k.device
        prompts = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
        if prompts.dim() == 1:
            prompts = prompts[None].expand(B, -1)
        P = prompts.shape[1]
        eos = self.cfg.eos_token_id
        routed = adapter_idx is not None
        key = self._key("beam", cache, K=K, P=P, routed=routed,
                        scores_int8=scores_int8, length_penalty=length_penalty,
                        suppress_ids=tuple(suppress_ids),
                        begin_suppress_ids=tuple(begin_suppress_ids),
                        segment=segment, timestamps=timestamps,
                        max_initial_timestamp_index=(
                            max_initial_timestamp_index if timestamps else None))

        params, cfg, lora, scale, kernels, tp = (self.params, self.cfg, self.lora,
                                                 self.lora_scale, self.kernels, self.tp)

        def build(seam):
            state = init_state(prompts, K, total, eos)
            idx = torch.empty(B, dtype=torch.int64, device=dev) if routed else None
            suppress, begin = (
                torch.tensor(ids, dtype=torch.int64, device=dev) if ids else None
                for ids in (suppress_ids, begin_suppress_ids))

            def body(lo, hi, n):
                def run():
                    new = beam_segment(
                        params, cache, cfg, state, lo, hi, n, P,
                        length_penalty=length_penalty, lora=lora,
                        adapter_idx=beam_row_adapters(idx, B, K, dev),
                        lora_scale=scale, scores_int8=scores_int8,
                        suppress=suppress, begin_suppress=begin,
                        timestamps=timestamps,
                        max_initial_timestamp_index=max_initial_timestamp_index,
                        kernels=kernels, tp=tp)
                    for dst, src in zip(state, new):
                        if src is not dst:
                            dst.copy_(src)
                return run

            return _Program([body(*g) for g in segments.grid(total, segment)],
                            lambda: ~state.unsat.any(), seam, (state, idx))

        with profiling.span("decode"):
            prog = self._program(key, build)
            state, idx = prog.static
            for dst, src in zip(state, init_state(prompts, K, total, eos)):
                dst.copy_(src)
            if routed:
                idx.copy_(torch.as_tensor(adapter_idx, device=dev))
            self._run(key, prog)
            return state.fin_seqs[:, 0].clone()

    def graph_stats(self) -> dict:
        """Programs, graphs, graph nodes and capture seconds so far."""
        seams = [p.seam for p in self._programs.values() if p.seam is not None]
        return {"programs": len(self._programs),
                "graphs": sum(len(s.graphs) for s in seams),
                "nodes": sum(s.nodes for s in seams),
                "capture_s": sum(s.seconds for s in seams)}
