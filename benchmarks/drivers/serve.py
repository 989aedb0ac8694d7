"""Serving cells: `TranscriptionService(router=AdapterRouter(...))` under
an open loop of independent users, each request sent by `submit` at its
due time on a seeded Poisson schedule at the workload's fixed rate.

Set-up makes the weights, a bank of LoRA adapters (B drawn nonzero, so
each adapter changes the logits) and an LID head from the seed, builds the
router and the service, and sends two full batches (the first captures the
decode loop's CUDA graphs). The window sends every request due in
`--seconds`; `latency_p95_ms` is the 95th percentile over all of them,
each timed from its due time to its result, a request that failed or had
no result a minute past the close counting as slower than any. A traced
run goes on after the window with an open loop of 2 x `profile_s` seconds
at the same rate and profiles its second half, the queue then in its
steady state with arrivals flowing, leaving out the drain after the last
send; the window itself runs unprofiled.

`correct`: a sample of the answered requests, drawn from the seed with
the longest in it, goes through the plain reference. Its LID (the first
encoder layers, mean pooling and the head, in float32) gives each
request's language log-probabilities; the widest gap between those and the
ones the service's router gave the request is `lid_logprob_gap`. Then the
adapted encoder and the teacher-forced decoder with the request's adapter
and its language's prompt score the served tokens: the widest gap by which
a served token lies below the reference's best is `max_logit_gap`. The
adapter is the one the service picked where the router's own
log-probabilities rank it first (it can then differ from the reference's
pick only as far as `lid_logprob_gap` allows), and the reference's pick
otherwise, so a request routed against its own LID reads as wrong tokens.
"""

from __future__ import annotations

import sys
import threading
import time

import numpy as np
import torch

from benchmarks import harness, weights
from benchmarks.drivers.eval import alter_token, program_config, served_tokens
from benchmarks.reference import compare, mel as ref_mel, whisper as ref
from benchmarks.traffic import arrivals, audio as audio_traffic


def make_bank(c: dict, lw: dict, seed: int, device) -> dict:
    """The adapter bank, in the port's layout: A ~ N(0, 1) / r (as the port
    initialises it) and B ~ N(0, b_std), float32, as adapters are saved."""
    g = weights.generator(seed, device, stream=2)
    A, r, d = len(lw["languages"]), lw["r"], c["d_model"]
    bank: dict = {"encoder": {}, "decoder": {}}
    for side, L, hooks in (("encoder", c["encoder_layers"], lw["encoder_hooks"]),
                           ("decoder", c["decoder_layers"], lw["decoder_hooks"])):
        for hook in hooks:
            bank[side][hook] = {
                "a": torch.randn((L, A, d, r), generator=g, device=device) / r,
                "b": torch.randn((L, A, r, d), generator=g, device=device) * lw["b_std"]}
    return bank


def make_head(c: dict, hw: dict, n_classes: int, seed: int, device) -> dict:
    """The LID head's parameters in the port's layout (input LayerNorm, MLP
    of Linear + LayerNorm + ReLU, output): uniform(+-1/sqrt(d_in))
    weights and biases, LayerNorms 1 + N(0, 0.02) and N(0, 0.02), float32."""
    g = weights.generator(seed, device, stream=3)

    def uni(shape, d_in):
        return (torch.rand(shape, generator=g, device=device) * 2 - 1) / np.sqrt(d_in)

    def ln(d):
        return {"scale": 1 + 0.02 * torch.randn(d, generator=g, device=device),
                "bias": 0.02 * torch.randn(d, generator=g, device=device)}
    p = {"ln": ln(c["d_model"])}
    prev = c["d_model"]
    for i, h in enumerate(hw["hidden_dims"]):
        p[f"mlp_{i}"] = {"w": uni((prev, h), prev), "b": uni((h,), prev)}
        p[f"mlp_ln_{i}"] = ln(h)
        prev = h
    p["out"] = {"w": uni((prev, n_classes), prev), "b": uni((n_classes,), prev)}
    return p


def head_logprobs(p: dict, hw: dict, feats: torch.Tensor,
                  prec: ref.Precision = ref.FP32) -> torch.Tensor:
    """The reference LID head: [T, d] features -> [K] log-probabilities
    (LayerNorm per frame, mean over frames, the MLP, log-softmax), its
    products' operands rounded by `prec`."""
    import torch.nn.functional as F

    def ln(x, q):
        return F.layer_norm(x, (x.shape[-1],), q["scale"], q["bias"], eps=1e-5)
    h = ln(feats.float(), p["ln"]).mean(0)
    for i in range(len(hw["hidden_dims"])):
        h = torch.relu(ln(prec.mm(h, p[f"mlp_{i}"]["w"]) + p[f"mlp_{i}"]["b"],
                          p[f"mlp_ln_{i}"]))
    return torch.log_softmax(prec.mm(h, p["out"]["w"]) + p["out"]["b"], -1)


class Traffic:
    """The requests of one run: due times at the fixed rate and clips whose
    durations come from a grid over [min_s, max_s], both orders drawn from
    the seed, and the audio drawn on the device in one call."""

    def __init__(self, t: dict, seed: int, seconds: float, device):
        self.n = max(1, int(round(t["rate_per_s"] * seconds)))
        self.due = arrivals.schedule(self.n, t["rate_per_s"], seed)
        durs = audio_traffic.duration_grid(self.n, t["min_s"], t["max_s"])
        self.durations = durs[audio_traffic.rng(seed, 17, 0).permutation(self.n)]
        lengths = np.round(self.durations * audio_traffic.SAMPLE_RATE).astype(np.int64)
        x = audio_traffic.noise(self.n, int(lengths.max()), seed, 2000, device)
        self.clips = [x[i, :lengths[i]] for i in range(self.n)]


def open_loop(svc, traffic: Traffic, grace_s: float, stretch=None) -> dict:
    """Send each request at its due time from this thread while a second
    thread waits for the results in order (one worker serves the queue in
    order, so results come in order). Returns each request's due, sent and
    done times (perf_counter seconds; done NaN where none came or it
    failed), its answer and detected language, and its handle. `stretch`
    (a `Stretch`) is told of each send."""
    n = traffic.n
    sent = np.full(n, np.nan)
    done = np.full(n, np.nan)
    answers: list = [None] * n
    handles: list = [None] * n
    ready = [threading.Event() for _ in range(n)]
    t0 = time.perf_counter()
    deadline = t0 + float(traffic.due[-1]) + grace_s

    def collect():
        for i in range(n):
            if not ready[i].wait(max(0.0, deadline - time.perf_counter())):
                return
            req = handles[i]
            if req is None or not req.done.wait(max(0.0, deadline - time.perf_counter())):
                continue
            t = time.perf_counter()
            if req.error is None:
                done[i] = t
                answers[i] = (req.text, req.detected)

    waiter = threading.Thread(target=collect, name="bench-collector")
    waiter.start()
    try:
        for i in range(n):
            wait = t0 + traffic.due[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            if stretch is not None:
                stretch.before_send(float(traffic.due[i]))
            sent[i] = time.perf_counter()
            try:
                handles[i] = svc.submit(traffic.clips[i])
            except Exception:       # noqa: BLE001 -- a refused request is a failed one
                handles[i] = None
            ready[i].set()
        if stretch is not None:
            stretch.after_sends()
    finally:
        for e in ready:
            e.set()
        waiter.join()
    return {"t0": t0, "due": t0 + traffic.due, "sent": sent, "done": done,
            "answers": answers, "handles": handles}


class Stretch:
    """The traced run's profiled stretch of an open loop: torch.profiler
    from the first send due at `from_s` or later to the last send, marked by
    a `bench.profiled` range; the drain that follows is profiled too but
    cut away, so the stretch is the service in its steady state."""

    def __init__(self, from_s: float, device):
        from torch.profiler import ProfilerActivity, profile
        self.from_s = from_s
        self.acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            self.acts.append(ProfilerActivity.CUDA)
        # The profiler's first start in a process takes seconds: pay it
        # here, so that the start inside the open loop does not stall sends.
        with profile(activities=self.acts):
            torch.zeros(1, device=device).add_(1)
        self.prof = self.mark = None

    def before_send(self, due_s: float) -> None:
        if self.prof is None and due_s >= self.from_s:
            from torch.profiler import profile, record_function
            self.prof = profile(activities=self.acts)
            self.prof.start()
            self.mark = record_function("bench.profiled")
            self.mark.__enter__()

    def after_sends(self) -> None:
        if self.mark is not None:
            self.mark.__exit__(None, None, None)

    def finish(self) -> tuple[list, list, float]:
        """Once the window has closed: (device operations, host events,
        seconds) of the marked stretch, each event cut to it."""
        self.prof.stop()
        kernels, host = harness.read_profile(self.prof)
        s, e = next((h[1], h[2]) for h in host if h[0] == "bench.profiled")
        kernels = [(n, max(a, s), min(b, e)) for n, a, b in kernels if b > s and a < e]
        host = [h for h in host if h[2] > s and h[1] < e]
        return kernels, host, (e - s) / 1e9


class LidRecord:
    """The language log-probabilities the service's router gave each
    request of the window: the `route` output of the request's batch, kept
    on the device until the window has closed."""

    def __init__(self, svc):
        self.batches: list = []
        route, run_batch = svc.router.route, svc._run
        last: dict = {}

        def routed(feats):
            idx, probs = route(feats)
            last["probs"] = probs
            return idx, probs

        def run(batch):
            out = run_batch(batch)
            self.batches.append((list(batch), last.pop("probs")))
            return out
        svc.router.route, svc._run = routed, run

    def by_request(self) -> dict:
        """id(request) -> log-probabilities [A], float32 on the host."""
        out = {}
        for batch, probs in self.batches:
            for r, row in zip(batch, probs[:len(batch)].float().log().cpu()):
                out[id(r)] = row
        return out


def build(ctx):
    """The cell's service, routed through an AdapterRouter made from the
    seed -> (service, base params)."""
    from sar_tpu_torch.models import whisper
    from sar_tpu_torch.models.classifier import ClassifierConfig
    from sar_tpu_torch.models.lora import LoraConfig
    from sar_tpu_torch.models.router import AdapterRouter
    from sar_tpu_torch.serving.service import TranscriptionService

    w, c, dev = ctx.cell.workload, ctx.cell.config, ctx.device
    sw, lw, hw = w["service"], w["lora"], w["lid"]
    cfg = program_config(c)
    params = whisper.cast_params(weights.make(c, ctx.seed, dev), torch.bfloat16)
    bank = make_bank(c, lw, ctx.seed, dev)
    head = make_head(c, hw, len(lw["languages"]), ctx.seed, dev)
    lcfg = LoraConfig(r=lw["r"], alpha=lw["alpha"], dropout=0.0,
                      target_modules=tuple(lw["target_modules"]))
    ccfg = ClassifierConfig(input_dim=c["d_model"], hidden_dims=tuple(hw["hidden_dims"]),
                            num_classes=len(lw["languages"]), dropout=0.0,
                            pooling=hw["pooling"], use_layer_norm=True,
                            languages=tuple(lw["languages"]), encoder_layer=hw["layer"])
    router = AdapterRouter(cfg, params, bank, lcfg, head, ccfg, device=dev,
                           kernels=w.get("kernels", True), capture=w.get("capture"))
    return TranscriptionService(router=router, batch_size=sw["batch_size"],
                                max_wait_ms=sw["max_wait_ms"],
                                max_new_tokens=w["max_new_tokens"]), params


def warm_up(svc, traffic: Traffic, batches: int, batch_size: int, marks: list) -> None:
    """Full batches of the cell's own shape, sent at once and awaited."""
    for k in range(batches):
        reqs = [svc.submit(traffic.clips[i % traffic.n]) for i in range(batch_size)]
        for r in reqs:
            r.result(timeout=600)
        marks.append((f"warm-up batch {k}", time.perf_counter()))


def run(ctx):
    w, c, dev = ctx.cell.workload, ctx.cell.config, ctx.device
    sw = w["service"]
    marks = [("start", time.perf_counter())]
    cfg = program_config(c)
    svc, params = build(ctx)
    router = svc.router
    if ctx.fault == "token":
        alter_token(router.runner, router.prompt_len + 1, c["vocab_size"])
    elif ctx.fault == "route":
        route = router.route

        def misroute(feats):
            idx, probs = route(feats)
            return (idx + 1) % len(w["lora"]["languages"]), probs
        router.route = misroute
    elif ctx.fault:
        raise ValueError(f"serve cells plant the faults 'token' and 'route', not {ctx.fault!r}")
    traffic = Traffic(w["traffic"], ctx.seed, ctx.seconds, dev)
    marks.append(("router, service and traffic", time.perf_counter()))
    try:
        warm_up(svc, traffic, w.get("warmup_batches", 2), sw["batch_size"], marks)
        lid = LidRecord(svc)
        before = svc.stats()
        ctx.start_window()
        res = open_loop(svc, traffic, w["grace_s"])
        after = svc.stats()
        lid_logp = lid.by_request()
        trace = None
        if ctx.trace:
            more = Traffic(w["traffic"], ctx.seed + 1, 2 * w["profile_s"], dev)
            stretch = Stretch(float(more.due[-1]) - w["profile_s"], dev)
            open_loop(svc, more, w["grace_s"], stretch)
            kernels, host, wall = stretch.finish()
            trace = harness.Trace(kernels=kernels, host=host, profiled_s=wall, config=c)
    finally:
        svc.close()
    lat = arrivals.latencies_ms(res["due"], res["done"])
    failed = int(np.isnan(lat).sum())
    batches = after["batches"] - before["batches"]
    fill = (100.0 * (after["rows_served"] - before["rows_served"])
            / (batches * sw["batch_size"]) if batches else float("nan"))
    if trace is not None:
        trace.extra = {"latencies_ms": lat, "batch_fill": fill}
    answered = [(i, *res["answers"][i], lid_logp.get(id(res["handles"][i])))
                for i in range(traffic.n) if res["answers"][i]]
    rows = compare.sample(answered, w["check"]["rows"], audio_traffic.rng(ctx.seed, 19),
                          lambda item: len(item[1]))
    late = (res["sent"] - res["due"]) * 1e3
    slow = np.argsort(np.where(np.isnan(lat), np.inf, lat))[::-1][:12]
    state = {"router": router, "svc": svc, "params": params}

    def release():
        state.clear()

    return harness.Outcome(
        attempted=traffic.n, failed=failed,
        metrics={"latency_p95_ms": arrivals.percentile(lat, 95)},
        release=release, trace=trace,
        check=lambda control=False: _check(ctx, c, cfg, w, traffic, rows, control),
        notes={"requests": traffic.n, "batches": batches, "batch_fill_pct": fill,
               "latency_p50_ms": arrivals.percentile(lat, 50),
               "generator_late_ms_max": float(np.nanmax(late)),
               "slowest (index, due s, ms)": [(int(i), round(float(traffic.due[i]), 2),
                                              round(float(lat[i]), 1)) for i in slow],
               "setup": [(k, round(t - a, 3)) for (_, a), (k, t) in zip(marks, marks[1:])]})


def _check(ctx, c, cfg, w, traffic, rows, control: bool = False) -> list:
    """`lid_logprob_gap` and `max_logit_gap` of the sampled requests under
    the reference (see the module's docstring); with `control`, the
    float8 control's readings of both beside them."""
    dev = ctx.device
    lw, hw = w["lora"], w["lid"]
    W = weights.make(c, ctx.seed, dev)
    bank = make_bank(c, lw, ctx.seed, dev)
    head = make_head(c, hw, len(lw["languages"]), ctx.seed, dev)
    worst = worst_ctl = lid_gap = lid_ctl = 0.0
    agree = 0
    with torch.no_grad(), ref.exact_float32():
        for i, ids, language, served_lp in rows:
            mel = ref_mel.log_mel([traffic.clips[i]], c["num_mel_bins"], dev)[0]
            ref_lp = head_logprobs(head, hw, ref.encode(W, c, mel, n_layers=hw["layer"] + 1))
            if served_lp is None:           # a request whose LID was not recorded
                lid_gap = float("inf")
                served_lp = torch.full_like(ref_lp, float("nan"))
            else:
                served_lp = served_lp.to(dev)
                lid_gap = max(lid_gap, float((served_lp - ref_lp).abs().max()))
            picked = lw["languages"].index(language)
            a = picked if picked == int(served_lp.argmax()) else int(ref_lp.argmax())
            agree += picked == int(ref_lp.argmax())
            adapter = ref.Adapter(bank, a, lw["alpha"] / lw["r"])
            prompt = cfg.prompt_ids(lw["languages"][a])
            toks = served_tokens(ids, w["max_new_tokens"], cfg.eos_token_id)
            seq = torch.tensor(prompt + toks, device=dev)[:-1]
            logits = ref.decoder_logits(W, c, ref.encode(W, c, mel, adapter=adapter), seq,
                                        adapter=adapter)
            worst = max(worst, float(compare.served_gaps(logits, len(prompt), toks).max()))
            if control:
                p = ref.FP8
                ctl_lp = head_logprobs(
                    head, hw, ref.encode(W, c, mel, n_layers=hw["layer"] + 1, prec=p), prec=p)
                lid_ctl = max(lid_ctl, float((ctl_lp - ref_lp).abs().max()))
                ctl = ref.decoder_logits(W, c, ref.encode(W, c, mel, adapter=adapter, prec=p),
                                         seq, adapter=adapter, prec=p)
                worst_ctl = max(worst_ctl, float(compare.control_gaps(
                    logits, ctl, len(prompt), len(toks)).max()))
    print(f"note reference LID: {agree} of {len(rows)} sampled picks agree with the "
          "service's", file=sys.stderr)
    lim, lid_lim = w["check"]["max_logit_gap"], w["check"]["lid_logprob_gap"]
    out = [compare.check("lid_logprob_gap", lid_gap, lid_lim),
           compare.check("max_logit_gap", worst, lim)]
    if control:
        out += [compare.check("control_fp8_lid_logprob_gap", lid_ctl, lid_lim),
                compare.check("control_fp8_max_logit_gap", worst_ctl, lim)]
    return out
