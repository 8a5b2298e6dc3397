"""The rollout kind: a closed loop of GRPO requests through the port's
``RolloutEngine`` at steady state.

Set-up builds the model from the seed and the engine from the mix's
``engine`` settings, re-admits every slot with a snapshot of a request
part-way through its answer (``admit_resume``), and steps until every
history is in the cache, a finished request's slot taking the next
request at once (``admit``).  The window then steps for ``seconds``: each
step's sampled tokens and its wall time make the rate and the gaps
between consecutive tokens of every sequence (their 95th percentile is a
per-layer metric: its spread between runs is wider than any bound).  A traced run goes on for
``trace_steps`` more steps under the profiler.

``correct``: once the window has closed and the engine is freed, the
reference runs once over a sample, drawn from the seed, of the requests
finished in the window (the one with the most served tokens in it), and
each served token is judged by its gap below the reference's best (with
the engine's Gumbel noise) and by its log-probability.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from hbench import devtrace, stats, weights
from hbench.drivers import common
from hbench.reference import serve
from hbench.reference.model import Reference
from hbench.traffic.generator import RolloutTraffic, rng

TRACE_STEPS = 16
SHAPE_EVERY = 4          # steps between reads of the decode shapes in the traced window
WARM_STEPS = 8


def _decode_shape(engine) -> Dict:
    """Contexts of the slots that decode in the next step, and the pool
    blocks they read (each once)."""
    bs = engine.block_size
    ctx = np.array([s.history_len + 1 if s.active and not s.ingesting else 0
                    for s in engine.slots])
    used = np.arange(engine.tables.shape[1])[None, :] < -(-ctx[:, None] // bs)
    blocks = np.unique(engine.tables[used]).size
    return {"contexts": ctx[ctx > 0].tolist(), "blocks": int(blocks), "block_size": bs}


def _mean_context(engine) -> float:
    c = [s.history_len + 1 for s in engine.slots if s.active and not s.ingesting]
    return float(np.mean(c)) if c else math.nan


def run(cell) -> Dict:
    from repro_torch.core.config import EngineConfig
    from repro_torch.core.rollout import RolloutEngine
    from repro_torch.kernels import ops
    from repro_torch.obs import trace

    dev = torch.device(cell.device)
    cfg, p = cell.cfg, cell.traffic
    marks = {"start": time.perf_counter() - cell.setup_t0}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        common.build_kernels()
    marks["built"] = time.perf_counter() - cell.setup_t0
    model = common.build_model(cfg, cell.seed, dev)
    eseed = int(rng(cell.seed, 9).integers(0, 2 ** 62))
    ecfg = EngineConfig(**p["engine"], seed=eseed, dtype=getattr(torch, cfg["dtype"]))
    engine = RolloutEngine(model, ecfg, device=dev)
    traffic = RolloutTraffic(p, cell.seed, int(cfg["vocab_size"]))
    for snap in traffic.initial():
        if engine.admit_resume(snap) is None:
            raise RuntimeError("the engine has no room for its own slots' snapshots")

    def admit_next() -> int:
        with devtrace.span("admit"):
            return engine.admit([traffic.next_request()])

    marks["admitted"] = time.perf_counter() - cell.setup_t0
    # fill: every history into the cache, finished slots refilled at once
    fill_steps = 0
    while engine.ingest_backlog_tokens() > 0:
        fill_steps += 1
        for _ in engine.step():
            admit_next()
    marks["filled"] = time.perf_counter() - cell.setup_t0
    for _ in range(WARM_STEPS):
        for _ in engine.step():
            admit_next()
    common.sync(dev)
    setup_s = time.perf_counter() - cell.setup_t0

    tr = trace.get()
    if cell.trace:
        tr.configure(enabled=True)
        tr.drain()
    ctx0 = _mean_context(engine)
    tok_start = engine.tokens_generated
    gaps: List[float] = []
    counts: List[int] = []
    finished = []
    attempted = failed = 0
    with common.steady_window():
        cpu0 = time.thread_time()
        t0 = t_prev = time.perf_counter()
        prev = tok_start
        while True:
            with devtrace.span("engine.step"):
                fin = engine.step()
            t = time.perf_counter()
            n = engine.tokens_generated - prev
            prev += n
            gaps.append(t - t_prev)
            counts.append(n)
            t_prev = t
            for f in fin:
                finished.append(f)
                attempted += 1
                failed += admit_next() != 1
            if t - t0 >= cell.seconds:
                break
        host_cpu_s = time.thread_time() - cpu0
    window_s = t_prev - t0
    tokens = engine.tokens_generated - tok_start
    ctx1 = _mean_context(engine)
    spans = {}
    if cell.trace:
        spans = common.span_durations(tr.drain())
        tr.configure(enabled=False)
    failed += sum(1 for f in finished if not all(math.isfinite(x) for x in f.logprobs))

    end_to_end = {"gen_tokens_per_s": stats.rate([tokens], [window_s]), "setup_s": setup_s}
    ctx = {"kind": "rollout", "cfg": cfg, "traffic": p, "spans": spans,
           "window": {"seconds": window_s, "tokens": tokens, "steps": len(gaps),
                      "mean_context": np.nanmean([ctx0, ctx1]),
                      "itl_p95_ms": stats.itl_p95_ms(gaps, counts)}}
    breakdown = None
    if cell.trace:
        launches0 = dict(ops.LAUNCHES)
        shapes = []
        traced = devtrace.Traced()
        with traced.window():
            for j in range(TRACE_STEPS):
                if j % SHAPE_EVERY == 0:
                    shapes.append(_decode_shape(engine))
                with devtrace.span("engine.step"):
                    fin = engine.step()
                for _ in fin:
                    admit_next()
        summ = traced.summary()
        ctx["profile"] = dict(summ, decode_shapes=shapes,
                              launches={k: ops.LAUNCHES[k] - launches0.get(k, 0)
                                        for k in ops.LAUNCHES})
        breakdown = common.breakdown(summ)
    peak = common.peak_bytes(dev)
    ctx["peak_bytes"] = peak
    device = common.device_record(dev, peak, ctx.get("profile"))

    # the reference, once the engine is freed
    pick = _sample(finished, traffic, int(p["check_requests"]), cell.seed)
    del engine, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings, extra = check(cell, pick, traffic, eseed, dev)
    extra.update(setup=marks, fill_steps=fill_steps, window_steps=len(gaps),
                 finished=len(finished), host_cpu_share=host_cpu_s / window_s,
                 itl_p95_ms=ctx["window"]["itl_p95_ms"],
                 step_ms=[1e3 * float(np.percentile(gaps, q)) for q in (5, 50, 80, 90, 95, 99)])
    return {"end_to_end": end_to_end, "ctx": ctx, "readings": readings, "attempted": attempted,
            "failed": failed, "device": device, "breakdown": breakdown, "extra": extra}


def _sample(finished, traffic: RolloutTraffic, n: int, seed: int):
    """The finished request with the most served tokens, and n - 1 others
    drawn from the seed."""
    if not finished:
        return []
    served = [len(f.response) - traffic.progress[f.rid] for f in finished]
    first = int(np.argmax(served))
    rest = [i for i in range(len(finished)) if i != first]
    r = rng(seed, 10)
    pick = [first] + [rest[i] for i in r.permutation(len(rest))[:max(0, n - 1)]]
    return [(finished[i], traffic.progress[finished[i].rid]) for i in pick]


def check(cell, pick, traffic, eseed: int, dev):
    """Readings of the served tokens against the reference; with
    ``cell.control`` also the control's, in fp8 at the same positions."""
    t_check = time.perf_counter()
    common.reference_precision()
    cfg = cell.cfg
    if not pick:
        return {"gap": math.nan, "lp_err": math.nan}, {"served_tokens": 0}
    w = weights.reference_leaves(cfg, cell.seed, dev)
    ref = Reference(cfg, w)
    ctl = Reference(cfg, w, quant="fp8") if cell.control else None
    vp = weights.padded_vocab(cfg)
    worst = {"gap": 0.0, "lp_err": 0.0}
    worst_ctl = {"gap": 0.0, "lp_err": 0.0}
    served = 0
    for f, first in pick:
        resp = list(f.response)
        if len(resp) <= first:
            continue
        lf = serve.answer_logits(ref, f.prompt, resp, first, dev)
        noise = serve.gumbel(eseed, f.rid, range(first, len(resp)), vp, dev)
        toks = torch.tensor(resp[first:], device=dev)
        lps = torch.tensor(f.logprobs[first:], device=dev, dtype=torch.float32)
        r = serve.served_readings(lf, noise, toks, lps)
        worst = {k: max(worst[k], r[k]) for k in worst}
        served += len(resp) - first
        if ctl is not None:
            cl = serve.answer_logits(ctl, f.prompt, resp, first, dev)
            c = serve.control_readings(lf, cl, noise)
            worst_ctl = {k: max(worst_ctl[k], c[k]) for k in worst_ctl}
    extra = {"served_tokens": served, "requests": len(pick),
             "check_s": time.perf_counter() - t_check}
    if ctl is not None:
        extra["control"] = worst_ctl
    return worst, extra
