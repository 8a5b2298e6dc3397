"""The train kind: the port's ``PPOTrainer.train_step`` on one global batch
a step, as AReaL's trainer worker runs it.

Set-up builds one model and trainer from the seed and drives them through
the mix's ``check_steps`` first steps (batches 0, 1, 2 of the seed), which
also builds and warms every kernel; the readings that ``correct`` compares
are taken from that same object on the way: each step's loss, each leaf's
norm of AdamW's first moment after the first step (m / (1 - beta1): the
clipped gradients as the optimizer got them) and each leaf's norm of its
change after the last.  The window then runs steps on fresh batches until
``seconds`` have passed, and ends with the last step that started.  A
traced run profiles one more step.

Once the window has closed and the trainer is freed, the float32
reference follows the same first steps from the same weights and batches.
"""
from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from hbench import devtrace, stats, weights
from hbench.drivers import common
from hbench.reference import train as reftrain
from hbench.traffic.generator import TrainTraffic


def trajectories(batch: List[Dict]):
    from repro_torch.core.buffer import Trajectory
    return [Trajectory(rid=t["rid"], prompt_id=t["prompt_id"],
                       prompt_tokens=list(t["prompt_tokens"]),
                       response_tokens=list(t["response_tokens"]),
                       behav_logprobs=list(t["behav_logprobs"]),
                       versions=[t["behavior_version"]] * len(t["response_tokens"]),
                       behavior_version=t["behavior_version"], reward=t["reward"])
            for t in batch]


def change_norms(current: Dict[str, torch.Tensor], cfg: Dict, seed: int) -> Dict[str, float]:
    """Each leaf's norm of its change from the seed's weights."""
    dev = next(iter(current.values())).device
    dt = getattr(torch, cfg["dtype"])
    return {n: float((current[n].detach().float() - w0.float()).norm())
            for n, w0 in weights.iter_leaves(cfg, seed, dev, dt)}


def run(cell) -> Dict:
    from repro_torch.configs.base import RLConfig
    from repro_torch.core.trainer import PPOTrainer
    from repro_torch.kernels import ops

    dev = torch.device(cell.device)
    cfg, p = cell.cfg, cell.traffic
    rl = dict(p["rl"])
    marks = {"start": time.perf_counter() - cell.setup_t0}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        common.build_kernels()
    marks["built"] = time.perf_counter() - cell.setup_t0
    model = common.build_model(cfg, cell.seed, dev)
    trainer = PPOTrainer(model, RLConfig(**rl))
    names = [n for n, _ in model.named_parameters()]
    traffic = TrainTraffic(p, cell.seed, int(cfg["vocab_size"]))
    beta1 = trainer.adam.beta1
    n_check = int(p["check_steps"])

    def step(k: int):
        batch = trajectories(traffic.batch(k))
        with devtrace.span("train_step"):
            return trainer.train_step(batch, current_version=traffic.max_staleness + k)

    prog: Dict[str, object] = {"loss": []}
    t_read = 0.0
    marks["model"] = time.perf_counter() - cell.setup_t0
    for k in range(n_check):
        m = step(k)
        marks[f"step{k}"] = time.perf_counter() - cell.setup_t0
        prog["loss"].append(m.loss)
        t = time.perf_counter()
        if k == 0:
            prog["moment"] = {n: float(x.norm()) / (1.0 - beta1)
                              for n, x in zip(names, trainer.opt_state["m"])}
        if k == n_check - 1:
            prog["change"] = change_norms(dict(model.named_parameters()), cfg, cell.seed)
        t_read += time.perf_counter() - t
    common.sync(dev)
    setup_s = time.perf_counter() - cell.setup_t0 - t_read

    steps, step_s, toks, n_mb, timings = [], [], [], [], []
    attempted = failed = 0
    k = n_check
    t0 = time.perf_counter()
    while True:
        batch = trajectories(traffic.batch(k))
        a = time.perf_counter()
        with devtrace.span("train_step"):
            m = trainer.train_step(batch, current_version=traffic.max_staleness + k)
        step_s.append(time.perf_counter() - a)
        attempted += 1
        ok = math.isfinite(m.loss) and all(math.isfinite(o["grad_norm"])
                                            for o in trainer.opt_metrics)
        failed += not ok
        toks.append(m.n_tokens)
        n_mb.append(m.n_microbatches)
        timings.append(dict(trainer.timings))
        steps.append(k)
        k += 1
        if time.perf_counter() - t0 >= cell.seconds:
            break
    end_to_end = {"train_tokens_per_s": stats.rate(toks, step_s), "setup_s": setup_s}
    ctx = {"kind": "train", "cfg": cfg, "traffic": p,
           "window": {"step_s": step_s, "tokens": toks, "microbatches": n_mb, "timings": timings,
                      "pack_len": int(rl["microbatch_token_budget"]),
                      "lengths": [_lengths(traffic.batch(j), rl) for j in steps[:1]]}}
    breakdown = None
    if cell.trace:
        launches0 = dict(ops.LAUNCHES)
        traced = devtrace.Traced()
        batch = trajectories(traffic.batch(k))
        with traced.window():
            with devtrace.span("train_step"):
                m = trainer.train_step(batch, current_version=traffic.max_staleness + k)
        summ = traced.summary()
        ctx["profile"] = dict(summ, lengths=_lengths(traffic.batch(k), rl),
                              microbatches=m.n_microbatches,
                              launches={n: ops.LAUNCHES[n] - launches0.get(n, 0)
                                        for n in ops.LAUNCHES})
        breakdown = common.breakdown(summ)
    peak = common.peak_bytes(dev)
    ctx["peak_bytes"] = peak
    device = common.device_record(dev, peak, ctx.get("profile"))

    del trainer, model, m
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    readings, extra = check(cell, traffic, prog, dev)
    extra.update(setup=marks, check_s=time.perf_counter() - t, step_s=step_s,
                 microbatches=n_mb, tokens=toks)
    return {"end_to_end": end_to_end, "ctx": ctx, "readings": readings, "attempted": attempted,
            "failed": failed, "device": device, "breakdown": breakdown, "extra": extra}


def _lengths(batch: List[Dict], rl: Dict) -> List[List[int]]:
    """Sequence lengths of each micro-batch of a batch, by Algorithm 1."""
    lens = [min(len(t["prompt_tokens"]) + len(t["response_tokens"]),
                int(rl["microbatch_token_budget"])) for t in batch]
    return [[lens[i] for i in g] for g in reftrain.algorithm1(lens, int(rl["microbatch_token_budget"]))]


def reference_run(cell, traffic: TrainTraffic, dev, *, quant=None, half=False) -> Dict:
    """The reference's readings over the first steps."""
    cfg = cell.cfg
    w = weights.reference_leaves(cfg, cell.seed, dev)
    rt = reftrain.ReferenceTrainer(cfg, w, cell.traffic["rl"], quant=quant)
    out: Dict[str, object] = {"loss": []}
    for k in range(int(cell.traffic["check_steps"])):
        batch = traffic.batch(k)
        if half:
            batch = batch[: len(batch) // 2]
        out["loss"].append(rt.step(batch))
        if k == 0:
            out["moment"] = rt.moment_norms()
    out["change"] = change_norms(rt.w, cfg, cell.seed)
    del rt, w
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Each step's loss gap (the worst); the worst leaf's gap of its
    moment norm and of its change norm, each over the larger of that
    leaf's reference norm and the median leaf's.  Leaves whose reference
    moment is under a thousandth of the median leaf's (their gradient is
    nought to rounding) are left out of the change."""
    loss = max(abs(a - b) for a, b in zip(prog["loss"], ref["loss"]))
    rm = ref["moment"]
    med_m = statistics.median(rm.values())
    grad = {n: abs(prog["moment"][n] - rm[n]) / max(rm[n], med_m) for n in rm}
    rc = ref["change"]
    moved = [n for n in rc if rm[n] >= 1e-3 * med_m]
    med_c = statistics.median(rc[n] for n in moved)
    change = {n: abs(prog["change"][n] - rc[n]) / max(rc[n], med_c, 1e-30) for n in moved}
    wg, wc = max(grad, key=grad.get), max(change, key=change.get)
    return {"loss": loss, "grad": grad[wg], "change": change[wc],
            "worst": {"grad": wg, "change": wc, "unmoved": len(rc) - len(moved)}}


def check(cell, traffic: TrainTraffic, prog: Dict, dev):
    common.reference_precision()
    ref = reference_run(cell, traffic, dev)
    readings = compare(prog, ref)
    extra = {"program_loss": prog["loss"], "reference_loss": ref["loss"],
             "grad": readings["grad"], "worst": readings.pop("worst")}
    if cell.control:
        extra["control"] = compare(reference_run(cell, traffic, dev, quant="fp8"), ref)
        extra["half_batch"] = compare(reference_run(cell, traffic, dev, half=True), ref)
    return readings, extra
