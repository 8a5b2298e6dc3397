#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA H100.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --quick    # environment, build and kernel checks only
    python3 chip_smoke.py --profile  # every phase, then a torch.profiler trace of decode steps

Phases, each printing one JSON line:
  1. env      torch/CUDA versions, the card, its compute capability and
              ``nvidia-smi``'s name and power limit; TF32 off.
  2. build    every kernel of ``src/repro_torch/csrc`` built with nvcc for
              sm_90a, all at once, and ptxas's register/spill report.
  3. kernel   each Hopper kernel held against its plain PyTorch version at
              the serving path's shapes, in bf16 and f32, then timed with
              CUDA events beside its bound, its plain version and one
              PyTorch library call computing the same function.
  4. small    the reduced model through the kernels on the card against
              the plain path on the CPU, same weights, f32.
  5. serve    ``build_model(get_model_config("areal-qwen-1.5b"))`` at full
              width in bf16, random weights from a seeded generator, behind
              a ring-cache ``RolloutEngine``: after a warm-up on a throwaway
              engine, 8 requests admitted, decoded, interrupted by an
              ``update_weights`` with perturbed weights, decoded to the end.
              Launch counts are set to 0 just before and read just after.
  6. profile  (``--profile`` only) device time of a few decode steps by
              kernel kind, and the card's idle share of a decode step.
Then the ``kernels`` line, the card's name and power limit, and the
result line.  Any failure raises, so the script exits non-zero.  It
exits non-zero with no result where no CUDA device is visible or the
port's sources are missing.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (dense): bf16 tensor cores, f32 outside them, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:69",
    "decode_attention": "src/repro/kernels/decode_attention.py:62",
}
SOURCES = {
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "decode_attention": "src/repro_torch/csrc/decode_attention.cu",
}
TOL = {"bfloat16": 2e-2, "float32": 2e-5}


def require(ok, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Mean device time of a call, by CUDA events around each launch, with
    the 50 MB L2 flushed before each one (the serving path meets every
    layer's cache cold).  A spin kernel queued ahead of each launch keeps
    the host's enqueue time (argument checks, allocation, the ctypes
    call) out of the interval between the events."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            self.flush_buf.zero_()
            torch.cuda._sleep(1_000_000)          # ~0.5 ms of device time
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / iters


# ---------------------------------------------------------------------------
# kernel inputs at the serving path's shapes
# ---------------------------------------------------------------------------

def flash_inputs(torch, np, rng, dtype, b, s, h, hkv, hd):
    q = torch.from_numpy(rng.standard_normal((b, s, h, hd), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((b, s, hkv, hd), dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((b, s, hkv, hd), dtype=np.float32))
    # right-padded rows, as a prefill of prompts of mixed lengths
    lengths = rng.integers(s // 2, s + 1, size=b)
    seg = np.where(np.arange(s)[None, :] < lengths[:, None], 0, -1).astype(np.int32)
    cuda = lambda x: x.to("cuda", dtype).contiguous()
    return cuda(q), cuda(k), cuda(v), torch.from_numpy(seg).cuda()


def ring_state(np, rng, b, w, t_hi):
    """cache_pos / t of ring caches whose slots hold the latest position
    <= t with that residue mod W, t spread over [0, t_hi), and about a
    tenth of the slots emptied."""
    t = rng.integers(0, t_hi, size=b).astype(np.int32)
    slot = np.arange(w)[None, :]
    latest = t[:, None] - ((t[:, None] - slot) % w)
    pos = np.where(latest >= 0, latest, -1).astype(np.int32)
    pos[rng.random((b, w)) < 0.1] = -1
    pos[np.arange(b), t % w] = t                       # the token itself is written
    return pos, t


def decode_inputs(torch, np, rng, dtype, b, h, hkv, hd, w):
    q = torch.from_numpy(rng.standard_normal((b, h, hd), dtype=np.float32))
    kc = torch.from_numpy(rng.standard_normal((b, w, hkv, hd), dtype=np.float32))
    vc = torch.from_numpy(rng.standard_normal((b, w, hkv, hd), dtype=np.float32))
    pos, t = ring_state(np, rng, b, w, 2 * w)
    cuda = lambda x: x.to("cuda", dtype).contiguous()
    return (cuda(q), cuda(kc), cuda(vc), torch.from_numpy(pos).cuda(),
            torch.from_numpy(t).cuda())


def flash_mask(torch, seg, s, window):
    qpos = torch.arange(s, device="cuda")[:, None]
    kpos = torch.arange(s, device="cuda")[None, :]
    mask = qpos >= kpos
    if window:
        mask &= (qpos - kpos) < window
    return mask[None, None] & (seg[:, None, :, None] == seg[:, None, None, :])


def decode_mask(pos, t, window):
    tb = t[:, None]
    valid = (pos >= 0) & (pos <= tb)
    if window:
        valid &= pos > tb - window
    return valid


def nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def check(name, got, want, dtype_name, case) -> float:
    import torch
    err = (got.float() - want.float()).abs()
    tol = TOL[dtype_name]
    bad = err > tol + tol * want.float().abs()
    if not torch.isfinite(got.float()).all() or bad.any():
        raise AssertionError(f"{name} {case} {dtype_name}: max abs err {err.max().item()} "
                             f"over tolerance {tol}")
    return err.max().item()


def kernel_phase(torch, np, quick: bool):
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    rng = np.random.default_rng(0)
    b, h, hkv, hd = 8, 12, 2, 128            # areal-qwen-1.5b, 8 slots
    prompt, max_len = 512, 768                # prompt width; re-prefill (max_len) width
    timer = None if quick else Timer(torch)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        # ---- flash attention: prefill and re-prefill widths, one windowed case
        for s, window in ((prompt, 0), (max_len, 0), (prompt, 256)):
            q, k, v, seg = flash_inputs(torch, np, rng, dtype, b, s, h, hkv, hd)
            case = f"B={b} S={s} H={h} Hkv={hkv} hd={hd} window={window}"
            got = flash_attention_cuda(q, k, v, seg, causal=True, window=window)
            want = ref.flash_attention(q, k, v, segment_ids=seg, causal=True, window=window)
            torch.cuda.synchronize()
            err = check("flash_attention", got, want, dn, case)
            rec = {"phase": "kernel", "name": "flash_attention", "dtype": dn, "case": case,
                   "max_abs_err": err, "tol": TOL[dn]}
            if timer is not None and (s, window) == (prompt, 0):
                mask = flash_mask(torch, seg, s, window)
                pairs = mask.sum().item() * h
                flops = 4.0 * hd * pairs
                byts = nbytes(q, k, v, seg, got)
                kx, vx = k.transpose(1, 2), v.transpose(1, 2)
                qx = q.transpose(1, 2)
                rec.update(
                    ms=timer(lambda: flash_attention_cuda(q, k, v, seg, causal=True)),
                    plain_ms=timer(lambda: ref.flash_attention(q, k, v, segment_ids=seg)),
                    library_ms=timer(lambda: F.scaled_dot_product_attention(
                        qx, kx, vx, attn_mask=mask, enable_gqa=True)),
                    flops=flops, bytes=byts,
                    bound_ms=1e3 * max(flops / PEAK_FLOPS[dn], byts / PEAK_BYTES),
                    bound_by="operations" if flops / PEAK_FLOPS[dn] > byts / PEAK_BYTES
                    else "bytes")
            emit(rec)
            if "ms" in rec and dn == "bfloat16":
                results["flash_attention"] = rec
        # ---- decode attention: ring caches at W = max_len, window 0 and > 0
        for window in (0, 256):
            q, kc, vc, pos, t = decode_inputs(torch, np, rng, dtype, b, h, hkv, hd, max_len)
            case = f"B={b} W={max_len} H={h} Hkv={hkv} hd={hd} window={window}"
            got = decode_attention_cuda(q, kc, vc, pos, t, window=window)
            want = ref.decode_attention(q, kc, vc, pos, t, window=window)
            torch.cuda.synchronize()
            err = check("decode_attention", got, want, dn, case)
            rec = {"phase": "kernel", "name": "decode_attention", "dtype": dn, "case": case,
                   "max_abs_err": err, "tol": TOL[dn]}
            if timer is not None and window == 0:
                valid = decode_mask(pos, t, window)
                n_valid = valid.sum().item()
                flops = 4.0 * hd * h * n_valid
                # K and V rows the mask keeps, every position, q, t and out
                byts = (2 * n_valid * hkv * hd * kc.element_size()
                        + nbytes(pos, t, q, got))
                mask = valid[:, None, None, :]
                qx = q[:, :, None, :]
                kx, vx = kc.transpose(1, 2), vc.transpose(1, 2)
                rec.update(
                    ms=timer(lambda: decode_attention_cuda(q, kc, vc, pos, t)),
                    plain_ms=timer(lambda: ref.decode_attention(q, kc, vc, pos, t)),
                    library_ms=timer(lambda: F.scaled_dot_product_attention(
                        qx, kx, vx, attn_mask=mask, enable_gqa=True)),
                    flops=flops, bytes=byts,
                    bound_ms=1e3 * max(flops / PEAK_FLOPS[dn], byts / PEAK_BYTES),
                    bound_by="operations" if flops / PEAK_FLOPS[dn] > byts / PEAK_BYTES
                    else "bytes")
            emit(rec)
            if "ms" in rec and dn == "bfloat16":
                results["decode_attention"] = rec
    return results


# ---------------------------------------------------------------------------
# small model: kernels on the card against the plain path on the CPU
# ---------------------------------------------------------------------------

def small_phase(torch, np):
    import dataclasses
    from repro_torch.configs import get_model_config, reduced
    from repro_torch.data import tokenizer
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(reduced(get_model_config("areal-qwen-1.5b")),
                              vocab_size=tokenizer.VOCAB_SIZE)
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gpu = build_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    b, s, max_len = 4, 24, 32
    toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(b, s)))
    length = torch.tensor([24, 17, 9, 1], dtype=torch.int32)
    out = {}
    for name, m in (("cpu", cpu), ("cuda", gpu)):
        dev = m.device
        cache = m.init_cache(b, max_len)
        logits, cache = m.prefill(toks.to(dev), cache, length=length.to(dev))
        steps = [logits]
        tok = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(b,))) if name == "cpu" \
            else out["tok"]
        out["tok"] = tok
        active = torch.tensor([True, True, False, True], device=dev)
        for _ in range(4):
            logits, cache = m.decode_step(tok.to(dev), cache, active)
            steps.append(logits)
        out[name] = [x.float().cpu() for x in steps] + [cache["k"].cpu(), cache["pos"].cpu()]
    tol = 1e-3   # f32 on both sides; other libraries, other summation orders
    err = 0.0
    for a, c in zip(out["cpu"], out["cuda"]):
        if a.dtype == torch.int32:
            if not torch.equal(a, c):
                raise AssertionError("cache positions differ between the card and the CPU")
            continue
        e = (a - c).abs().max().item()
        if not (e <= tol + tol * a.abs().max().item()):
            raise AssertionError(f"small model: card vs CPU max abs err {e}")
        err = max(err, e)
    emit({"phase": "small", "config": cfg.name, "max_abs_err": err, "tol": tol})


# ---------------------------------------------------------------------------
# the serving path at full width
# ---------------------------------------------------------------------------

def serve_phase(torch, np):
    from repro_torch.configs import get_model_config
    from repro_torch.core.config import EngineConfig
    from repro_torch.core.rollout import RolloutEngine
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model

    cfg = get_model_config("areal-qwen-1.5b")
    n_slots, prompt_len, max_gen_len, interrupt_at = 8, 512, 256, 96
    t0 = time.perf_counter()
    m0 = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    m0.init(torch.Generator(device="cuda").manual_seed(0))
    m1 = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        for p1, p0 in zip(m1.parameters(), m0.parameters()):
            p1.copy_(p0 * 1.01)                    # the perturbed policy, version 1
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in m0.parameters())
    init_s = time.perf_counter() - t0

    engine = RolloutEngine(m0, EngineConfig(
        n_slots=n_slots, prompt_len=prompt_len, max_gen_len=max_gen_len,
        temperature=1.0, seed=0, dtype=torch.bfloat16))
    rng = np.random.default_rng(0)
    lengths = rng.integers(256, prompt_len + 1, size=n_slots)
    reqs = [{"rid": i, "prompt_id": i, "answer": None,
             "prompt": rng.integers(3, cfg.vocab_size, size=int(n)).tolist()}
            for i, n in enumerate(lengths)]
    # lazy set-up (cuBLAS handles and heuristics, the allocator's pools)
    # happens once per process: pay it on a throwaway engine, report it
    t0 = time.perf_counter()
    warm = RolloutEngine(m0, EngineConfig(n_slots=n_slots, prompt_len=prompt_len,
                                          max_gen_len=max_gen_len, dtype=torch.bfloat16))
    warm.admit(reqs)
    for _ in range(2):
        warm.step()
    del warm
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launches()
    t0 = time.perf_counter()
    admitted = engine.admit(reqs)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    prefill_calls, decode_steps = 1, 0
    done = {}
    step_ms, reprefill_ms = [], None
    while len(done) < n_slots:
        if decode_steps == interrupt_at:
            t0 = time.perf_counter()
            require(engine.update_weights(m1, version=1), "update_weights was deferred")
            torch.cuda.synchronize()
            reprefill_ms = 1e3 * (time.perf_counter() - t0)
            prefill_calls += 1
        t0 = time.perf_counter()
        fin = engine.step()
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        decode_steps += 1
        for f in fin:
            done[f.rid] = f
        if decode_steps > max_gen_len + 1:
            raise AssertionError("requests did not finish")
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    require(admitted == n_slots, f"admitted {admitted} of {n_slots}")
    require(len(done) == n_slots, f"finished {len(done)} of {n_slots}")
    require(any(set(f.versions) == {0, 1} for f in done.values()),
            "no trajectory spans versions 0 and 1")
    for f in done.values():
        require(len(f.response) == len(f.logprobs) == len(f.versions) >= 1, f"rid {f.rid}")
        require(all(math.isfinite(x) and x <= 1e-6 for x in f.logprobs),
                f"rid {f.rid}: a logprob is not finite or above 0")
        require(all(0 <= x < cfg.vocab_size for x in f.response),
                f"rid {f.rid}: a token outside the vocabulary")
        require(f.versions == sorted(f.versions), f"rid {f.rid}: versions out of order")
    n_layers = cfg.n_layers
    if launches["flash_attention"] != n_layers * prefill_calls:
        raise AssertionError(f"flash_attention launches {launches['flash_attention']} != "
                             f"{n_layers} x {prefill_calls} prefill calls")
    if launches["decode_attention"] != n_layers * decode_steps:
        raise AssertionError(f"decode_attention launches {launches['decode_attention']} != "
                             f"{n_layers} x {decode_steps} decode steps")
    st = engine.stats()
    decode_s = sum(step_ms) / 1e3
    rec = {"phase": "serve", "model": cfg.name, "params": n_params, "dtype": "bfloat16",
           "n_slots": n_slots, "prompt_len": prompt_len, "max_gen_len": max_gen_len,
           "prompt_lengths": [int(x) for x in lengths], "init_s": init_s,
           "warmup_s": warmup_s,
           "prefill_ms": prefill_ms, "reprefill_ms": reprefill_ms,
           "decode_steps": decode_steps, "prefill_calls": prefill_calls,
           "decode_step_ms_mean": sum(step_ms) / len(step_ms),
           "decode_step_ms_median": sorted(step_ms)[len(step_ms) // 2],
           "decode_step_ms_p95": sorted(step_ms)[int(0.95 * len(step_ms))],
           "generated_tokens_per_s": st["tokens_generated"] / decode_s,
           "peak_memory_gb": peak_gb, "launches": launches, "stats": st,
           "versions_spanned": sum(set(f.versions) == {0, 1} for f in done.values())}
    emit(rec)
    return launches, engine, reqs, rec["decode_step_ms_mean"]


KINDS = (("flash_attention", ("flash_fwd_kernel",)),
         ("decode_attention", ("decode_split_kernel", "decode_combine_kernel")),
         ("matmul", ("gemm", "gemv", "cutlass", "xmma", "nvjet", "cublas")))


def profile_phase(torch, engine, reqs, step_ms: float, steps: int = 8):
    """Device time of a few decode steps by kernel kind, from a
    torch.profiler trace, and the share of an unprofiled decode step
    (``step_ms``, from the serve phase) that the card sat idle; the
    profiler slows the host, so its own wall time is reported apart."""
    from torch.profiler import ProfilerActivity, profile

    engine.admit([dict(r, rid=100 + r["rid"]) for r in reqs])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_kind = {k: 0.0 for k, _ in KINDS}
    by_kind["other"] = 0.0
    spans = []
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        spans.append((e.time_range.start, e.time_range.end))
        kind = next((k for k, keys in KINDS if any(s in e.name for s in keys)), "other")
        by_kind[kind] += dur
    busy, end = 0.0, -math.inf
    for s, e in sorted(spans):               # union of kernel intervals
        if e > end:
            busy += e - max(s, end)
            end = e
    rec = {"phase": "profile", "decode_steps": steps,
           "profiled_wall_ms_per_step": wall_us / steps / 1e3,
           "kernels_per_step": len(kernels) / steps}
    if kernels:
        rec.update(device_busy_ms_per_step=busy / steps / 1e3,
                   device_idle_share=1.0 - busy / steps / 1e3 / step_ms,
                   device_ms_per_step_by_kind={k: v / steps / 1e3 for k, v in by_kind.items()})
    else:
        rec["device_time"] = "not measured: the profiler recorded no CUDA kernels"
    emit(rec)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="environment, build and kernel checks only")
    ap.add_argument("--profile", action="store_true",
                    help="after the serving path, trace a few decode steps with torch.profiler")
    args = ap.parse_args()
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py: src/repro_torch is missing; run it from a checkout of "
              "the repository", file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    # 1. environment
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "device_count": torch.cuda.device_count(), "nvidia_smi": smi})

    # 2. build, every source at once
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    report = build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_s": {n: r["seconds"] for n, r in report.items()},
          "ptxas": {n: [ln.strip() for ln in r["log"].splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n, r in report.items()}})

    # 3. kernels against their plain versions, timed
    timed = kernel_phase(torch, np, args.quick)
    # 4. small model, card against CPU
    small_phase(torch, np)
    launches = {name: None for name in REPLACES}
    if not args.quick:
        # 5. the serving path at full width
        launches, engine, reqs, step_ms = serve_phase(torch, np)
        missing = [n for n, c in launches.items() if not c]
        if missing:
            raise AssertionError(f"kernels never launched on the serving path: {missing}")
        rows = []
        for name in REPLACES:
            r = timed[name]
            rows.append({"name": name, "route": "cuda", "source": SOURCES[name],
                         "replaces": REPLACES[name], "launches": launches[name],
                         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                         "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        if args.profile:
            profile_phase(torch, engine, reqs, step_ms)
        emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
