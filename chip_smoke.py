#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA H100.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --quick    # environment, build and kernel checks only
    python3 chip_smoke.py --profile  # every phase, then torch.profiler traces of decode steps,
                                     # of a hybrid admission prefill and of a train step

Phases, each printing one JSON line:
  1. env      torch/CUDA versions, the card, its compute capability and
              ``nvidia-smi``'s name and power limit; TF32 off.
  2. build    every kernel of ``src/repro_torch/csrc`` built with nvcc for
              sm_90a, all at once, and ptxas's register/spill report.
  3. kernel   each Hopper kernel held against its plain PyTorch version, in
              bf16 and f32: the paged kernels over the case tables of
              ``tests/test_kernels.py`` and its poisoned partial blocks,
              paged prefill over spans at fixed starts (``PP_SPAN_CASES``)
              and every split plan (bitwise equal twice), paged decode and
              the fused tail over their edges (``PAGED_EDGE_CASES``: hd 40,
              block sizes 8/16/32, an unbound slot, a window opening inside
              a tile, B = 20 at D = 1536; forced split plans, every call
              twice, bitwise equal; at the serving shapes one call each
              captured in a CUDA graph and replayed), flash attention
              over its edges (``FLASH_EDGE_CASES``: ragged S with B > 1,
              padding segments, windows opening inside a tile), the linear
              scan over ``LS_CASES`` and ``LS_EDGE_CASES`` (ragged S and C,
              resets and underflowing products; every call twice, bitwise
              equal; a graph replay) and at ``LS_TIMED``'s shapes (the
              RG-LRU prefill's, each timed), decode attention over its edges
              (``DECODE_EDGE_CASES`` and ``HYBRID_DECODE_EDGE_CASES``: W = 1,
              ragged W, groups of 1/6/16, a slot that sees no key, windows
              opening inside a tile, forced split plans, a NaN tail past W;
              every call twice, bitwise equal; at the serving shapes one
              call captured in a CUDA graph and replayed), and every kernel
              at its serving path's shapes (flash and decode attention at
              both models' head widths, 128 and 256; flash at S=512 and
              768; paged prefill at [0, 128), [384, 512) and [512, 640)),
              where it is timed with CUDA events beside its bound, its plain
              version and one PyTorch library call computing the same
              function.
     train_kernel  the flash-attention backward kernel, and the forward's
              log-sum-exp, against their plain versions over ``BWD_SHAPES``
              x ``BWD_VARIANTS`` in f32 and bf16 (hd 64/128, B 1/4, S
              1/37/256/768, H/Hkv 4/2 and 12/2; causal, windowed,
              non-causal; packed segments with a -1 tail), every call twice
              bitwise equal, each timed beside the plain backward and
              SDPA's backward, and at the ``train`` phase's micro-batch
              (one packed row of 6144 tokens: 8 segments of 727, then
              padding); each gradient also within a norm-relative error
              ``NORM_TOL`` of its reference, whole and per head.  At that
              row the forward with its log-sum-exp is also checked and
              timed beside SDPA's forward (``train_forward``).
  4. small    the reduced models through the kernels on the card against
              the plain path on the CPU, same weights, f32: the dense one's
              ring prefill and decode, paged prefill, chunked paged prefill,
              paged decode unfused and fused; the RG-LRU hybrid's ring
              prefill and decode (head_dim 256, MQA, a local window shorter
              than the prompt); ``small_train``: one ``train_step`` of the
              reduced dense model on the card and on the CPU.
  5. serve    ``build_model(get_model_config("areal-qwen-1.5b"))`` at full
              width in bf16, random weights from a seeded generator, behind
              a ring-cache ``RolloutEngine``: after a warm-up on a throwaway
              engine, 8 requests admitted, decoded, interrupted by an
              ``update_weights`` with perturbed weights, decoded to the end.
  6. serve_paged  the same model behind the paged engine (blocks of 16,
              prefix sharing, ``evict="lru"``, chunked prefill of 128 and
              the fused decode tail): 2 prompts sampled 4 times each, one
              interrupting weight update that re-ingests every history.
  7. serve_paged_unfused  the same traffic with monolithic paged prefill
              (flash attention) and the unfused paged decode.
  8. serve_hybrid  ``recurrentgemma-9b`` (38 layers: 26 RG-LRU, 12 local
              attention at head_dim 256 over one kv head) at full width in
              bf16 behind the ring-cache engine, with phase 5's traffic and
              interruption, after the dense models are freed.
  9. train    areal-qwen-1.5b at full width behind ``PPOTrainer`` (bf16
              weights, f32 m/v), after the hybrid is freed: the ring engine
              generates two GRPO groups of 16 answers, packed by Algorithm 1
              into micro-batches of 6144 tokens (6-10 sequences a row),
              ``train_step``, a second batch
              interrupted by ``update_weights(trainer.params, 1)``, a second
              ``train_step``; the step's time split, trained tokens/s, peak
              memory, flash forward and backward launches (28 x their
              calls), and the hand-off checked not to alias.
              In phases 5-9 launch counts are set to 0 just before the
              engine is driven and read just after.
 10. profile  (``--profile`` only) device time of a few decode steps of
              each serving phase's engine by kernel kind, and the card's
              idle share of a decode step; of one admission prefill of the
              hybrid (the linear scan's share of its device time); and of
              one more ``train_step``.
Then the ``kernels`` line, the card's name and power limit, and the
result line.  Any failure raises, so the script exits non-zero.  It
exits non-zero with no result where no CUDA device is visible or the
port's sources are missing.
"""
from __future__ import annotations

import argparse
import copy
import gc
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
    "paged_decode_attention": "src/repro/kernels/paged_decode_attention.py:77",
    "paged_prefill_attention": "src/repro/kernels/paged_prefill_attention.py:80",
    "fused_decode_tail": "src/repro/kernels/fused_decode_tail.py:89",
    "linear_scan": "src/repro/kernels/linear_scan.py:48",
    "flash_attention_bwd": "none: the gradient of ref.flash_attention by XLA autodiff "
                           "(src/repro/kernels/ref.py:25)",
}
SOURCES = {name: f"src/repro_torch/csrc/{name}.cu" for name in REPLACES}
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# gradients, as a whole and per (batch, head): rms(got - want) within
# rel x rms(want) + floor.  bf16's rel: the kernel rounds P and dS to bf16
# (2^-9) for its products, and a dropped or misweighted tile moves a head's
# norm by far more than 1%.  The floor, 1e-4 of a typical entry, covers
# gradients that cancel to rounding noise: a token that sees only itself
# has dq = dk = 0 up to the f32 rounding of dO.v - D (~8e-7 rms at hd 128)
NORM_TOL = {"bfloat16": (1e-2, 1e-5), "float32": (1e-5, 1e-5)}


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


# b, h, hkv, hd, w, window, variant: W = 1 and ragged W (not a multiple
# of the 16-key tile), groups of 1, 6 and 16, B = 64 with W = 32, windows
# opening inside a tile, a slot that sees no key ("empty": it gives 0),
# forced split plans 1, 2 and one per tile ("plans"), and B = 1 caches
# that are a view [:, :W] of a longer buffer whose tail is NaN
# ("nan_tail": no row past W is read).  Every call runs twice and must
# give the same bits.  Head widths of areal-qwen-1.5b's path, then of the
# hybrid's local attention.
DECODE_EDGE_CASES = [
    (2, 12, 2, 128, 1, 0, None), (3, 12, 2, 128, 17, 0, None), (2, 12, 2, 128, 100, 0, None),
    (2, 6, 2, 64, 1000, 0, None), (2, 4, 4, 64, 200, 0, None), (2, 6, 1, 64, 300, 0, None),
    (2, 16, 1, 64, 130, 40, None), (2, 8, 8, 128, 300, 0, None), (2, 6, 1, 128, 257, 0, None),
    (2, 32, 2, 128, 333, 50, None), (64, 12, 2, 128, 32, 0, None),
    (2, 12, 2, 128, 1000, 37, None), (3, 12, 2, 128, 768, 0, "empty"),
    (2, 12, 2, 128, 1000, 0, "plans"), (1, 12, 2, 128, 100, 0, "nan_tail")]
HYBRID_DECODE_EDGE_CASES = [
    (1, 16, 1, 256, 1, 0, None), (2, 16, 1, 256, 100, 0, None), (2, 2, 2, 256, 150, 0, None),
    (2, 12, 2, 256, 515, 0, None), (2, 16, 1, 256, 2048, 1000, None),
    (3, 16, 1, 256, 300, 0, "empty"), (2, 16, 1, 256, 768, 100, "plans"),
    (1, 16, 1, 256, 777, 0, "nan_tail")]


def graph_check(torch, name: str, call) -> str:
    """One call of a kernel captured in a CUDA graph (a cooperative launch
    whose barriers read their base from their counts when they run)
    replays to the bits of the eager call, twice."""
    eager = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()                                  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        require(torch.equal(out, eager), f"{name}: a graph replay differs")
    return "bitwise equal to the eager call, twice"


def decode_graph_check(torch, q, kc, vc, pos, t) -> str:
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    return graph_check(torch, "decode_attention",
                       lambda: decode_attention_cuda(q, kc, vc, pos, t))


def decode_edge_check(torch, np, dtype, cases, table: str, seed: int) -> None:
    """decode attention over an edge-case table, against its plain version."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import TILE, decode_attention_split

    dn = str(dtype).split(".")[1]
    rng = np.random.default_rng(seed)
    err = 0.0
    for case in cases:
        b, h, hkv, hd, w, window, variant = case
        q, kc, vc, pos, t = decode_inputs(torch, np, rng, dtype, b, h, hkv, hd, w)
        if variant == "empty":
            pos[-1] = -1
        if variant == "nan_tail":
            tail = lambda x: torch.cat([x, torch.full_like(x[:, :64], float("nan"))], 1)[:, :w]
            kc, vc = tail(kc), tail(vc)
        want = ref.decode_attention(q, kc, vc, pos, t, window=window)
        live = slice(0, b - 1) if variant == "empty" else slice(0, b)
        for n_split in (None, 1, 2, -(-w // TILE)) if variant == "plans" else (None,):
            got = decode_attention_split(q, kc, vc, pos, t, n_split, window=window)
            again = decode_attention_split(q, kc, vc, pos, t, n_split, window=window)
            torch.cuda.synchronize()
            require(torch.equal(got, again),
                    f"decode_attention {case} n_split={n_split}: two calls differ")
            err = max(err, check("decode_attention", got[live], want[live], dn,
                                 (case, n_split)))
            if variant == "empty":
                require(bool(torch.all(got[-1] == 0)),
                        f"decode_attention {case}: a slot that sees no key is not 0")
    emit({"phase": "kernel", "name": "decode_attention", "dtype": dn, "cases": table,
          "max_abs_err": err, "tol": TOL[dn]})


# b, s, h, hkv, hd, window, segments, causal: ragged S (not a multiple of
# 64 or 128), padding segments at the tail ("pad"), packed segments (True),
# windows whose first visible key falls inside a tile; head_dim 64/128/256;
# and without the causal mask
FLASH_EDGE_CASES = [
    (3, 577, 4, 2, 128, 0, "pad", True), (2, 200, 4, 1, 64, 0, "pad", True),
    (2, 577, 16, 1, 256, 0, "pad", True), (2, 300, 4, 2, 128, 100, "pad", True),
    (1, 577, 16, 1, 256, 200, True, True), (2, 200, 4, 2, 64, 70, False, True),
    (2, 130, 6, 2, 64, 48, True, True), (1, 96, 4, 2, 256, 0, False, True),
    (2, 200, 4, 2, 128, 0, "pad", False), (1, 300, 4, 1, 256, 100, True, False),
    (2, 130, 6, 2, 64, 0, False, False)]


def edge_inputs(torch, np, rng, dtype, b, s, h, hkv, hd, segs):
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to("cuda", dtype)
               for shape in ((b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd)))
    seg = None
    if segs == "pad":
        lengths = rng.integers(s // 2, s + 1, size=b)
        seg = np.where(np.arange(s)[None, :] < lengths[:, None], 0, -1).astype(np.int32)
    elif segs:
        seg = np.sort(rng.integers(0, 4, size=(b, s)), axis=1).astype(np.int32)
    return q, k, v, None if seg is None else torch.from_numpy(seg).cuda()


def flash_mask(torch, seg, s, window, causal=True):
    qpos = torch.arange(s, device="cuda")[:, None]
    kpos = torch.arange(s, device="cuda")[None, :]
    mask = qpos >= kpos if causal else torch.ones((s, s), dtype=torch.bool, device="cuda")
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


def bound(flops: float, byts: float, dtype_name: str):
    """The least time the card could take: bytes over HBM bandwidth or
    operations over the peak rate of their type, whichever is larger."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], byts / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def check(name, got, want, dtype_name, case) -> float:
    import torch
    err = (got.float() - want.float()).abs()
    tol = TOL[dtype_name]
    bad = err > tol + tol * want.float().abs()
    if not torch.isfinite(got.float()).all() or bad.any():
        raise AssertionError(f"{name} {case} {dtype_name}: max abs err {err.max().item()} "
                             f"over tolerance {tol}")
    return err.max().item()


def rms_rel(got, want) -> float:
    """rms(got - want) / rms(want) over the whole tensor."""
    d, w = got.float() - want.float(), want.float()
    return (d.square().mean().sqrt() / w.square().mean().sqrt().clamp_min(1e-30)).item()


def check_norm(name, got, want, dtype_name, case) -> float:
    """Hold a (B, S, H, hd) gradient by its rms error, whole and per
    (batch, head): rms(got - want) <= rel x rms(want) + floor.  Returns
    the largest per-head error over ``rel x rms(want) + floor``."""
    rel, floor = NORM_TOL[dtype_name]
    d, w = got.float() - want.float(), want.float()
    err = d.square().mean().sqrt().item()
    lim = rel * w.square().mean().sqrt().item() + floor
    head_err = d.square().mean(dim=(1, 3)).sqrt()
    head_lim = rel * w.square().mean(dim=(1, 3)).sqrt() + floor
    worst = (head_err / head_lim).max().item()
    if err > lim or worst > 1.0:
        raise AssertionError(f"{name} {case} {dtype_name}: rms err {err} over {lim}, or a "
                             f"head's over its limit by {worst}x")
    return max(err / lim, worst)


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
            if timer is not None and window == 0:
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
            if "ms" in rec and dn == "bfloat16" and s == prompt:
                results["flash_attention"] = rec
        # ---- flash attention's edges: ragged S with B > 1 (TMA zero-fills the
        # rows past S), padding segments, windows opening inside a tile
        err = 0.0
        erng = np.random.default_rng(10)     # its own: the cases after keep their inputs
        for b_, s_, h_, hkv_, hd_, window, segs, causal in FLASH_EDGE_CASES:
            q, k, v, seg = edge_inputs(torch, np, erng, dtype, b_, s_, h_, hkv_, hd_, segs)
            got = flash_attention_cuda(q, k, v, seg, causal=causal, window=window)
            want = ref.flash_attention(q, k, v, segment_ids=seg, causal=causal, window=window)
            torch.cuda.synchronize()
            err = max(err, check("flash_attention", got, want, dn,
                                 (b_, s_, h_, hkv_, hd_, window, segs, causal)))
        emit({"phase": "kernel", "name": "flash_attention", "dtype": dn,
              "cases": "FLASH_EDGE_CASES", "max_abs_err": err, "tol": TOL[dn]})
        # ---- decode attention: ring caches at W = max_len, window 0 and > 0
        for window in (0, 256):
            q, kc, vc, pos, t = decode_inputs(torch, np, rng, dtype, b, h, hkv, hd, max_len)
            case = f"B={b} W={max_len} H={h} Hkv={hkv} hd={hd} window={window}"
            got = decode_attention_cuda(q, kc, vc, pos, t, window=window)
            again = decode_attention_cuda(q, kc, vc, pos, t, window=window)
            want = ref.decode_attention(q, kc, vc, pos, t, window=window)
            torch.cuda.synchronize()
            require(torch.equal(got, again), f"decode_attention {case}: two calls differ")
            err = check("decode_attention", got, want, dn, case)
            rec = {"phase": "kernel", "name": "decode_attention", "dtype": dn, "case": case,
                   "max_abs_err": err, "tol": TOL[dn]}
            if dn == "bfloat16" and window == 0:
                rec["graph_replay"] = decode_graph_check(torch, q, kc, vc, pos, t)
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
        decode_edge_check(torch, np, dtype, DECODE_EDGE_CASES, "DECODE_EDGE_CASES", seed=12)
    return results


# ---------------------------------------------------------------------------
# paged kernels: the case tables of tests/test_kernels.py, the poisoned
# partial blocks and the paged engine's own shapes
# ---------------------------------------------------------------------------

PD_CASES = [   # b, h, hkv, hd, bs, entries, window
    (1, 4, 4, 32, 8, 4, 0), (2, 8, 2, 64, 16, 6, 0), (3, 8, 1, 80, 8, 5, 16),
    (2, 4, 2, 128, 32, 3, 48)]
FT_CASES = [   # b, h, hkv, hd, bs, entries, window, d_model
    (1, 4, 4, 32, 8, 4, 0, 48), (2, 8, 2, 64, 16, 6, 0, 128), (3, 8, 1, 80, 8, 5, 16, 56),
    (2, 4, 2, 128, 32, 3, 48, 96)]
PP_CASES = [   # b, c, h, hkv, hd, bs, entries, window
    (1, 8, 4, 4, 32, 8, 4, 0), (2, 5, 8, 2, 64, 16, 6, 0), (3, 16, 8, 1, 80, 8, 5, 16),
    (2, 3, 4, 2, 128, 32, 3, 48)]


# b, c, h, hkv, hd, bs, entries, window, span start, n_split (bf16; f32
# takes one split): spans at 0, mid-block, [384, 512) and [512, 640)
PP_SPAN_CASES = [
    (1, 128, 12, 2, 128, 16, 48, 0, 0, 2), (2, 100, 8, 2, 64, 16, 12, 0, 7, 2),
    (1, 128, 12, 2, 128, 16, 48, 0, 384, 1), (1, 128, 12, 2, 128, 16, 48, 0, 384, 8),
    (2, 128, 12, 2, 128, 16, 48, 0, 512, 10), (3, 70, 8, 1, 80, 8, 40, 48, 200, 2),
    (2, 150, 4, 2, 32, 16, 20, 0, 140, 3)]


# b, h, hkv, hd, bs, entries, window, d_model, variant: the paged decode
# kernels' edges (as tests/test_torch_paged_kernels.py's KERNEL_CASES):
# hd 40 (not a multiple of 16), block sizes 8, 16 and 32, a slot whose
# table is all unbound ("unbound"), a window opening inside a tile, B = 20
# slots at D = 1536 (two row tiles of the fused tail's projection).  Each
# at forced split plans 1, 2 and the most the resident grid takes, and the
# wrapper's; every call twice, bitwise equal.
PAGED_EDGE_CASES = [
    (3, 8, 2, 40, 16, 10, 0, 64, None), (4, 12, 2, 128, 8, 64, 0, 256, None),
    (4, 12, 2, 128, 16, 32, 0, 256, None), (4, 12, 2, 128, 32, 16, 0, 256, None),
    (3, 12, 2, 128, 16, 20, 0, 128, "unbound"), (3, 12, 2, 128, 16, 20, 37, 128, None),
    (20, 12, 2, 128, 16, 48, 0, 1536, None)]


def paged_edge_check(torch, np, dtype, seed: int) -> None:
    """Both paged decode kernels over PAGED_EDGE_CASES, against their
    plain versions."""
    from repro_torch.kernels import fused_decode_tail as ft
    from repro_torch.kernels import paged_decode_attention as pd
    from repro_torch.kernels import ref

    dn = str(dtype).split(".")[1]
    code = 1 if dtype == torch.bfloat16 else 0
    rng = np.random.default_rng(seed)
    errs = {"paged_decode_attention": 0.0, "fused_decode_tail": 0.0}
    for case in PAGED_EDGE_CASES:
        b, h, hkv, hd, bs, entries, window, d, variant = case
        kp, vp, tab, t = paged_case(np, rng, b, hkv, hd, bs, entries)
        if variant == "unbound":
            tab[0] = -1
        q = rng.standard_normal((b, h, hd), dtype=np.float32)
        wo = rng.standard_normal((h * hd, d), dtype=np.float32) * (h * hd) ** -0.5
        q, kp, vp, wo = (torch.from_numpy(x).to("cuda", dtype) for x in (q, kp, vp, wo))
        tab, t = torch.from_numpy(tab).cuda(), torch.from_numpy(t).cuda()
        act = tab.max(dim=1).values >= 0
        want = {"paged_decode_attention": ref.paged_decode_attention(q, kp, vp, tab, t,
                                                                     window=window),
                "fused_decode_tail": ref.fused_decode_tail(q, kp, vp, wo, tab, t,
                                                           window=window)}
        cap = min(pd._capacity(code, hd, q.device), ft._capacity(code, h, hkv, hd, q.device))
        most = min(-(-entries * bs // 16), cap // (b * hkv))
        for n_split in sorted({1, min(2, most), most}) + [None]:
            for name, call, chk in (
                    ("paged_decode_attention",
                     lambda: pd.paged_decode_attention_split(q, kp, vp, tab, t, n_split,
                                                             window=window), check),
                    ("fused_decode_tail",
                     lambda: ft.fused_decode_tail_split(q, kp, vp, wo, tab, t, n_split,
                                                        window=window), check_scaled)):
                got, again = call(), call()
                torch.cuda.synchronize()
                where = (case, n_split)
                require(torch.equal(got, again), f"{name} {where}: two calls differ")
                require(bool(torch.all(got[~act] == 0)),
                        f"{name} {where}: a slot with no visible key is not 0")
                errs[name] = max(errs[name], chk(name, got[act], want[name][act], dn, where))
    emit({"phase": "kernel", "dtype": dn, "cases": "PAGED_EDGE_CASES, forced split plans",
          "max_abs_err": errs, "tol": TOL[dn]})


def span_case(np, rng, b, c, hkv, hd, bs, entries, start):
    """Pool and tables whose slot s holds a span of c queries ending at
    t = start + c - 1 - s, its entries bound up to t and unbound after."""
    n_pool = b * entries + 2
    kp = rng.standard_normal((n_pool, bs, hkv, hd), dtype=np.float32)
    vp = rng.standard_normal((n_pool, bs, hkv, hd), dtype=np.float32)
    perm = rng.permutation(n_pool)
    tables = np.full((b, entries), -1, np.int32)
    t = np.array([start + c - 1 - s for s in range(b)], np.int32)
    for s in range(b):
        nb = int(t[s]) // bs + 1
        tables[s, :nb] = perm[s * entries:s * entries + nb]
    return kp, vp, tables, t


def paged_case(np, rng, b, hkv, hd, bs, entries):
    """Pool, tables and t as ``tests/test_kernels.py::_paged_case`` makes
    them: partial last blocks, unbound tails, and the last slot empty
    when b > 1."""
    n_pool = b * entries + 2
    kp = rng.standard_normal((n_pool, bs, hkv, hd), dtype=np.float32)
    vp = rng.standard_normal((n_pool, bs, hkv, hd), dtype=np.float32)
    tables = np.full((b, entries), -1, np.int32)
    t = np.zeros((b,), np.int32)
    perm = rng.permutation(n_pool)
    nxt = 0
    for i in range(b):
        if b > 1 and i == b - 1:
            continue
        nb = int(rng.integers(1, entries + 1))
        tables[i, :nb] = perm[nxt:nxt + nb]
        nxt += nb
        t[i] = int(rng.integers((nb - 1) * bs, nb * bs))
    return kp, vp, tables, t


def engine_pool(np, rng, b, hkv, hd, bs, entries, t_lo, t_hi, group=4):
    """A pool as the paged engine leaves it: slots in groups of ``group``
    that share the first t_lo // bs blocks (their prompt's full blocks),
    each slot's own blocks after them, positions t in [t_lo, t_hi)."""
    n_pool = b * entries
    kp = rng.standard_normal((n_pool, bs, hkv, hd), dtype=np.float32)
    vp = rng.standard_normal((n_pool, bs, hkv, hd), dtype=np.float32)
    perm = iter(rng.permutation(n_pool).tolist())
    tables = np.full((b, entries), -1, np.int32)
    t = rng.integers(t_lo, t_hi, size=b).astype(np.int32)
    shared = {}
    n_shared = t_lo // bs
    for i in range(b):
        if i // group not in shared:
            shared[i // group] = [next(perm) for _ in range(n_shared)]
        tables[i, :n_shared] = shared[i // group]
        for e in range(n_shared, int(t[i]) // bs + 1):
            tables[i, e] = next(perm)
    return kp, vp, tables, t


def distinct_rows(tab, valid, bs: int) -> int:
    """Pool rows (block, offset) that some slot's mask keeps, each counted
    once: a prompt block shared by a group is read once per call, not once
    per slot.  tab (B, E) int32, valid (B, E*bs) bool."""
    import torch
    pos = torch.arange(tab.shape[1] * bs, device=tab.device)
    row = tab[:, pos // bs].long() * bs + pos % bs
    return torch.unique(row[valid]).numel()


def check_scaled(name, got, want, dtype_name, case) -> float:
    """max |got - want| within tol times the output's largest magnitude:
    each output of the fused tail sums H * hd products of contexts that
    are themselves rounded to the working dtype."""
    import torch
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if not torch.isfinite(got.float()).all() or not err <= TOL[dtype_name] * scale:
        raise AssertionError(f"{name} {case} {dtype_name}: max abs err {err} over "
                             f"{TOL[dtype_name]} x output scale {scale}")
    return err


def paged_kernel_phase(torch, np, quick: bool):
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_decode_tail import fused_decode_tail_cuda
    from repro_torch.kernels.paged_decode_attention import paged_decode_attention_cuda
    from repro_torch.kernels.paged_prefill_attention import paged_prefill_attention_cuda

    rng = np.random.default_rng(1)
    cuda = lambda x, dt: torch.from_numpy(np.ascontiguousarray(x)).to("cuda", dt)
    dev_i = lambda x: torch.from_numpy(np.ascontiguousarray(x)).cuda()
    timer = None if quick else Timer(torch)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        errs = {"paged_decode_attention": 0.0, "fused_decode_tail": 0.0,
                "paged_prefill_attention": 0.0}
        # ---- the case tables ------------------------------------------
        for b, h, hkv, hd, bs, entries, window in PD_CASES:
            kp, vp, tab, t = paged_case(np, rng, b, hkv, hd, bs, entries)
            q = cuda(rng.standard_normal((b, h, hd), dtype=np.float32), dtype)
            kp, vp, tab, t = cuda(kp, dtype), cuda(vp, dtype), dev_i(tab), dev_i(t)
            got = paged_decode_attention_cuda(q, kp, vp, tab, t, window=window)
            want = ref.paged_decode_attention(q, kp, vp, tab, t, window=window)
            torch.cuda.synchronize()
            act = tab.max(dim=1).values >= 0
            errs["paged_decode_attention"] = max(errs["paged_decode_attention"], check(
                "paged_decode_attention", got[act], want[act], dn, (b, h, hkv, hd, bs, window)))
            require(bool(torch.all(got[~act] == 0)),
                    "paged_decode_attention: an empty slot is not 0")
        for b, h, hkv, hd, bs, entries, window, d in FT_CASES:
            kp, vp, tab, t = paged_case(np, rng, b, hkv, hd, bs, entries)
            q = cuda(rng.standard_normal((b, h, hd), dtype=np.float32), dtype)
            wo = cuda(rng.standard_normal((h * hd, d), dtype=np.float32) * hd ** -0.5, dtype)
            kp, vp, tab, t = cuda(kp, dtype), cuda(vp, dtype), dev_i(tab), dev_i(t)
            got = fused_decode_tail_cuda(q, kp, vp, wo, tab, t, window=window)
            want = ref.fused_decode_tail(q, kp, vp, wo, tab, t, window=window)
            torch.cuda.synchronize()
            act = tab.max(dim=1).values >= 0
            errs["fused_decode_tail"] = max(errs["fused_decode_tail"], check_scaled(
                "fused_decode_tail", got[act], want[act], dn, (b, h, hkv, hd, bs, window, d)))
        for b, c, h, hkv, hd, bs, entries, window in PP_CASES:
            kp, vp, tab, t = paged_case(np, rng, b, hkv, hd, bs, entries)
            q = cuda(rng.standard_normal((b, c, h, hd), dtype=np.float32), dtype)
            qpos = t[:, None] - np.arange(c)[::-1][None, :]
            qpos = np.where(qpos >= 0, qpos, -1).astype(np.int32)
            kp, vp, tab, qp = cuda(kp, dtype), cuda(vp, dtype), dev_i(tab), dev_i(qpos)
            got = paged_prefill_attention_cuda(q, kp, vp, tab, qp, window=window)
            want = ref.paged_prefill_attention(q, kp, vp, tab, qp, window=window)
            torch.cuda.synchronize()
            ok = (qp >= 0) & (tab.max(dim=1).values >= 0)[:, None]
            errs["paged_prefill_attention"] = max(errs["paged_prefill_attention"], check(
                "paged_prefill_attention", got[ok], want[ok], dn,
                (b, c, h, hkv, hd, bs, window)))
            require(bool(torch.all(got[qp < 0] == 0)),
                    "paged_prefill_attention: a padded row is not 0")
        # ---- poisoned partial blocks (test_kernels.py:174, :243) -------
        b, h, hkv, hd, bs, d = 1, 2, 2, 32, 8, 24
        q = cuda(rng.standard_normal((b, h, hd), dtype=np.float32), dtype)
        kp = cuda(rng.standard_normal((4, bs, hkv, hd), dtype=np.float32), dtype)
        vp = cuda(rng.standard_normal((4, bs, hkv, hd), dtype=np.float32), dtype)
        wo = cuda(rng.standard_normal((h * hd, d), dtype=np.float32), dtype)
        tab = torch.tensor([[2, 1]], dtype=torch.int32, device="cuda")
        t = torch.tensor([bs + 2], dtype=torch.int32, device="cuda")
        kp2, vp2 = kp.clone(), vp.clone()
        kp2[1, 4:] = 1e3
        vp2[1, 4:] = -1e3
        errs["paged_decode_attention"] = max(errs["paged_decode_attention"], check(
            "paged_decode_attention", paged_decode_attention_cuda(q, kp2, vp2, tab, t),
            ref.paged_decode_attention(q, kp, vp, tab, t), dn, "poisoned tail"))
        errs["fused_decode_tail"] = max(errs["fused_decode_tail"], check_scaled(
            "fused_decode_tail", fused_decode_tail_cuda(q, kp2, vp2, wo, tab, t),
            ref.fused_decode_tail(q, kp, vp, wo, tab, t), dn, "poisoned tail"))
        emit({"phase": "kernel", "dtype": dn, "cases": "PD/FT/PP tables and poisoned tails",
              "max_abs_err": errs, "tol": TOL[dn]})
        paged_edge_check(torch, np, dtype, seed=14)

        # ---- the paged engine's shapes --------------------------------
        b, h, hkv, hd, bs, entries, dm = 8, 12, 2, 128, 16, 48, 1536
        kp, vp, tab, t = engine_pool(np, rng, b, hkv, hd, bs, entries, 256, 768)
        q = cuda(rng.standard_normal((b, h, hd), dtype=np.float32), dtype)
        wo = cuda(rng.standard_normal((h * hd, dm), dtype=np.float32) * (h * hd) ** -0.5, dtype)
        kp, vp, tab, t = cuda(kp, dtype), cuda(vp, dtype), dev_i(tab), dev_i(t)
        case = f"B={b} H={h} Hkv={hkv} hd={hd} pool=({kp.shape[0]}, {bs}) E={entries}"
        kg, vg, kpos = ref.gather_pool(kp, vp, tab)
        valid = decode_mask(kpos, t, 0)
        n_valid = valid.sum().item()                 # (slot, key) pairs: the FLOPs
        # bytes: each visible pool row once, though 4 slots see a shared one
        kv_bytes = 2 * distinct_rows(tab, valid, bs) * hkv * hd * kp.element_size()
        qx, kx, vx = q[:, :, None, :], kg.transpose(1, 2), vg.transpose(1, 2)
        mask = valid[:, None, None, :]
        sdpa = lambda: F.scaled_dot_product_attention(qx, kx, vx, attn_mask=mask,
                                                      enable_gqa=True)
        for name, fn, plain, lib, flops, byts in (
                ("paged_decode_attention",
                 lambda: paged_decode_attention_cuda(q, kp, vp, tab, t),
                 lambda: ref.paged_decode_attention(q, kp, vp, tab, t),
                 sdpa, 4.0 * hd * h * n_valid, kv_bytes + nbytes(q, tab, t, q)),
                ("fused_decode_tail",
                 lambda: fused_decode_tail_cuda(q, kp, vp, wo, tab, t),
                 lambda: ref.fused_decode_tail(q, kp, vp, wo, tab, t),
                 lambda: torch.matmul(sdpa().reshape(b, h * hd), wo),
                 4.0 * hd * h * n_valid + 2.0 * b * h * hd * dm,
                 kv_bytes + nbytes(q, tab, t, wo) + b * dm * q.element_size())):
            got, again, want = fn(), fn(), plain()
            torch.cuda.synchronize()
            require(torch.equal(got, again), f"{name} {case}: two calls differ")
            chk = check_scaled if name == "fused_decode_tail" else check
            rec = {"phase": "kernel", "name": name, "dtype": dn, "case": case,
                   "max_abs_err": chk(name, got, want, dn, case), "tol": TOL[dn]}
            if dn == "bfloat16":
                rec["graph_replay"] = graph_check(torch, name, fn)
            if timer is not None:
                rec.update(ms=timer(fn), plain_ms=timer(plain), library_ms=timer(lib),
                           flops=flops, bytes=byts, kv_bytes=kv_bytes, **bound(flops, byts, dn))
                if name == "fused_decode_tail":   # the unfused path it stands against
                    rec["paged_decode_plus_matmul_ms"] = timer(lambda: torch.matmul(
                        paged_decode_attention_cuda(q, kp, vp, tab, t).reshape(b, h * hd), wo))
            emit(rec)
            if dn == "bfloat16":
                results[name] = rec
        # chunked-prefill spans of C=128 queries on slot 0's table, its
        # entries bound up to the span's end: the engine's first span [0,
        # 128), an admission span [384, 512) and a re-ingest span [512, 640)
        c = 128
        srng = np.random.default_rng(11)     # its own: the cases after keep their inputs
        used = set(tab.flatten().tolist())
        spare = [i for i in range(kp.shape[0]) if i not in used]
        for start in (0, 384, 512):
            tab1 = tab[:1].clone()
            need = (start + c + bs - 1) // bs
            tab1[0, need:] = -1
            for e in range(need):
                if tab1[0, e] < 0:
                    tab1[0, e] = spare.pop()
            qc = cuda(srng.standard_normal((1, c, h, hd), dtype=np.float32), dtype)
            qpos = torch.arange(start, start + c, dtype=torch.int32, device="cuda")[None]
            case = f"B=1 C={c} H={h} Hkv={hkv} hd={hd} q_pos=[{start}, {start + c})"
            fn = lambda: paged_prefill_attention_cuda(qc, kp, vp, tab1, qpos)
            plain = lambda: ref.paged_prefill_attention(qc, kp, vp, tab1, qpos)
            got, want = fn(), plain()
            torch.cuda.synchronize()
            rec = {"phase": "kernel", "name": "paged_prefill_attention", "dtype": dn,
                   "case": case, "tol": TOL[dn],
                   "max_abs_err": check("paged_prefill_attention", got, want, dn, case)}
            if dn == "bfloat16":
                # every split plan, from one split to one per visible key
                # tile, computes the same function, and twice the same bits
                for n_split in (1, 2, (start + c + 63) // 64):
                    got = paged_prefill_attention_cuda(qc, kp, vp, tab1, qpos, n_split=n_split)
                    again = paged_prefill_attention_cuda(qc, kp, vp, tab1, qpos,
                                                         n_split=n_split)
                    torch.cuda.synchronize()
                    require(torch.equal(got, again),
                            f"paged_prefill_attention {case} n_split={n_split}: two calls differ")
                    rec["max_abs_err"] = max(rec["max_abs_err"], check(
                        "paged_prefill_attention", got, want, dn, f"{case} n_split={n_split}"))
            if timer is not None:
                kg1, vg1, kpos1 = ref.gather_pool(kp, vp, tab1)
                vis = (kpos1[:, None, :] >= 0) & (kpos1[:, None, :] <= qpos[:, :, None])
                n_keys = ((kpos1 >= 0) & (kpos1 < start + c)).sum().item()
                flops = 4.0 * hd * h * vis.sum().item()
                byts = 2 * n_keys * hkv * hd * kp.element_size() + nbytes(qc, qpos, tab1, qc)
                lmask = vis[:, None]
                qx1, kx1, vx1 = qc.transpose(1, 2), kg1.transpose(1, 2), vg1.transpose(1, 2)
                rec.update(ms=timer(fn), plain_ms=timer(plain),
                           library_ms=timer(lambda: F.scaled_dot_product_attention(
                               qx1, kx1, vx1, attn_mask=lmask, enable_gqa=True)),
                           flops=flops, bytes=byts, **bound(flops, byts, dn))
            emit(rec)
            if dn == "bfloat16" and start == 384:
                results["paged_prefill_attention"] = rec
        # spans of the kernel tests' table at fixed starts, forced plans
        err = 0.0
        for b_, c_, h_, hkv_, hd_, bs_, entries_, window, start, n_split in PP_SPAN_CASES:
            kp_, vp_, tab_, t_ = span_case(np, srng, b_, c_, hkv_, hd_, bs_, entries_, start)
            q = cuda(srng.standard_normal((b_, c_, h_, hd_), dtype=np.float32), dtype)
            qpos = t_[:, None] - np.arange(c_)[::-1][None, :]
            qpos = np.where(qpos >= 0, qpos, -1).astype(np.int32)
            kp_, vp_, tab_, qp = cuda(kp_, dtype), cuda(vp_, dtype), dev_i(tab_), dev_i(qpos)
            ns = n_split if dn == "bfloat16" else 1
            got = paged_prefill_attention_cuda(q, kp_, vp_, tab_, qp, window=window, n_split=ns)
            again = paged_prefill_attention_cuda(q, kp_, vp_, tab_, qp, window=window,
                                                 n_split=ns)
            want = ref.paged_prefill_attention(q, kp_, vp_, tab_, qp, window=window)
            torch.cuda.synchronize()
            case = (b_, c_, h_, hkv_, hd_, bs_, window, start, ns)
            require(torch.equal(got, again), f"paged_prefill_attention {case}: two calls differ")
            require(bool(torch.all(got[qp < 0] == 0)),
                    f"paged_prefill_attention {case}: a padded row is not 0")
            err = max(err, check("paged_prefill_attention", got[qp >= 0], want[qp >= 0], dn,
                                 case))
        emit({"phase": "kernel", "name": "paged_prefill_attention", "dtype": dn,
              "cases": "PP_SPAN_CASES, forced split plans", "max_abs_err": err,
              "tol": TOL[dn]})
    return results


# ---------------------------------------------------------------------------
# the RG-LRU hybrid's kernels: the linear scan, and attention at head_dim 256
# ---------------------------------------------------------------------------

LS_CASES = [(1, 32, 16), (2, 64, 64), (1, 100, 200), (3, 256, 128)]   # tests/test_kernels.py
# ragged shapes: one step, around both default spans (32 and 128 steps),
# C not a multiple of the 32-channel tile or of 4; "resets": a = 0 at
# chosen steps and a run of 1e-12 whose slice products underflow
LS_EDGE_CASES = [(2, 1, 33, None), (2, 31, 200, None), (8, 33, 4096, None),
                 (1, 127, 4100, None), (1, 129, 4100, None), (2, 300, 200, "resets"),
                 (8, 300, 4096, "resets")]
# the shapes the RG-LRU prefill gives the scan: recurrentgemma-9b's lru_width
# 4096, 8 slots at S=512 (the table row), the engine's admission and
# re-prefill lengths, one slot, and bf16
LS_TIMED = [(8, 512, 4096, "float32"), (8, 463, 4096, "float32"), (8, 559, 4096, "float32"),
            (1, 512, 4096, "float32"), (1, 4096, 4096, "float32"), (8, 512, 4096, "bfloat16")]
LS_NO_LIBRARY = ("no single PyTorch call computes a diagonal linear recurrence; "
                 "a cumprod/cumsum form underflows where the decay products vanish")


def ls_inputs(torch, np, rng, dtype, b, s, c, variant=None):
    a = rng.uniform(0.5, 1.0, size=(b, s, c)).astype(np.float32)
    if variant == "resets":
        a[:, [32, 41, 64, 130]] = 0.0
        a[:, 96:112] = 1e-12
    cuda = lambda v: torch.from_numpy(np.ascontiguousarray(v)).to("cuda", dtype)
    return (cuda(a), cuda(rng.standard_normal((b, s, c), dtype=np.float32)),
            cuda(rng.standard_normal((b, c), dtype=np.float32)))


def ls_check(torch, a, x, h0, dn, case) -> float:
    """linear_scan twice (bitwise equal) against its plain version."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.linear_scan import linear_scan_cuda
    got, again = linear_scan_cuda(a, x, h0), linear_scan_cuda(a, x, h0)
    want = ref.linear_scan(a, x, h0)
    torch.cuda.synchronize()
    require(all(torch.equal(u, v) for u, v in zip(got, again)),
            f"linear_scan {case}: two calls differ")
    return max(check("linear_scan", got[0], want[0], dn, case),
               check("linear_scan", got[1], want[1], dn, case))


def hybrid_kernel_phase(torch, np, quick: bool):
    """linear_scan over the case tables (with and without h0; every call
    twice, bitwise equal) and at ``LS_TIMED``'s shapes, a graph replay
    at the serving shape; flash attention at B=8 S=512 H=16 Hkv=1 hd=256
    and across a local window (S=2560, window 2048); ring decode
    attention at B=8 W=768 and on a wrapped ring of width 2048 with
    window 2048."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.linear_scan import linear_scan_cuda, scan_plan

    rng = np.random.default_rng(3)
    timer = None if quick else Timer(torch)
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        err = 0.0
        for b, s, c, variant in [case + (None,) for case in LS_CASES] + LS_EDGE_CASES:
            a, x, h0 = ls_inputs(torch, np, rng, dtype, b, s, c, variant)
            for init in (h0, None):
                err = max(err, ls_check(torch, a, x, init, dn,
                                        (b, s, c, variant, init is not None)))
        emit({"phase": "kernel", "name": "linear_scan", "dtype": dn,
              "cases": "LS_CASES and LS_EDGE_CASES with and without h0, twice bitwise equal",
              "max_abs_err": err, "tol": TOL[dn]})
    scan = None
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for b, s, c, dn in LS_TIMED:
        a, x, _ = ls_inputs(torch, np, rng, getattr(torch, dn), b, s, c)
        case = f"B={b} S={s} C={c} h0=None"
        v, w, l = scan_plan(b, c, getattr(torch, dn))
        rec = {"phase": "kernel", "name": "linear_scan", "dtype": dn, "case": case,
               "plan": {"V": v, "W": w, "L": l, "span": w * l, "tile": 32 * v,
                        "blocks": b * -(-c // (32 * v)), "sms": n_sm},
               "max_abs_err": ls_check(torch, a, x, None, dn, case), "tol": TOL[dn]}
        if scan is None:
            rec["graph_replay"] = graph_check(torch, "linear_scan",
                                              lambda: linear_scan_cuda(a, x)[0])
        if timer is not None:
            flops = 2.0 * b * s * c
            byts = 3 * nbytes(a) + b * c * a.element_size()      # a, x, h, h_last
            rec.update(ms=timer(lambda: linear_scan_cuda(a, x)),
                       plain_ms=timer(lambda: ref.linear_scan(a, x), iters=5, warmup=1),
                       library_ms=None, library=LS_NO_LIBRARY, flops=flops, bytes=byts,
                       **bound(flops, byts, dn))
        emit(rec)
        scan = scan or rec
        del a, x

    h, hkv, hd = 16, 1, 256                   # recurrentgemma-9b's local attention
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        for b, s, window in ((8, 512, 0), (2, 2560, 2048)):
            q, k, v, seg = flash_inputs(torch, np, rng, dtype, b, s, h, hkv, hd)
            case = f"B={b} S={s} H={h} Hkv={hkv} hd={hd} window={window}"
            got = flash_attention_cuda(q, k, v, seg, causal=True, window=window)
            want = ref.flash_attention(q, k, v, segment_ids=seg, causal=True, window=window)
            torch.cuda.synchronize()
            rec = {"phase": "kernel", "name": "flash_attention", "dtype": dn, "case": case,
                   "max_abs_err": check("flash_attention", got, want, dn, case),
                   "tol": TOL[dn]}
            del want
            if timer is not None and dn == "bfloat16" and s == 512:
                mask = flash_mask(torch, seg, s, window)
                flops = 4.0 * hd * mask.sum().item() * h
                byts = nbytes(q, k, v, seg, got)
                qx, kx, vx = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
                rec.update(
                    ms=timer(lambda: flash_attention_cuda(q, k, v, seg, causal=True)),
                    plain_ms=timer(lambda: ref.flash_attention(q, k, v, segment_ids=seg)),
                    library_ms=timer(lambda: F.scaled_dot_product_attention(
                        qx, kx, vx, attn_mask=mask, enable_gqa=True)),
                    flops=flops, bytes=byts, **bound(flops, byts, dn))
            emit(rec)
        for b, w, window in ((8, 768, 0), (8, 2048, 2048)):
            q, kc, vc, pos, t = decode_inputs(torch, np, rng, dtype, b, h, hkv, hd, w)
            case = f"B={b} W={w} H={h} Hkv={hkv} hd={hd} window={window} t<{2 * w}"
            got = decode_attention_cuda(q, kc, vc, pos, t, window=window)
            again = decode_attention_cuda(q, kc, vc, pos, t, window=window)
            want = ref.decode_attention(q, kc, vc, pos, t, window=window)
            torch.cuda.synchronize()
            require(torch.equal(got, again), f"decode_attention {case}: two calls differ")
            rec = {"phase": "kernel", "name": "decode_attention", "dtype": dn, "case": case,
                   "max_abs_err": check("decode_attention", got, want, dn, case),
                   "tol": TOL[dn]}
            if dn == "bfloat16" and w == 768:
                rec["graph_replay"] = decode_graph_check(torch, q, kc, vc, pos, t)
            if timer is not None and dn == "bfloat16" and w == 768:
                valid = decode_mask(pos, t, window)
                n_valid = valid.sum().item()
                flops = 4.0 * hd * h * n_valid
                byts = 2 * n_valid * hkv * hd * kc.element_size() + nbytes(pos, t, q, got)
                qx, kx, vx = q[:, :, None, :], kc.transpose(1, 2), vc.transpose(1, 2)
                mask = valid[:, None, None, :]
                rec.update(
                    ms=timer(lambda: decode_attention_cuda(q, kc, vc, pos, t)),
                    plain_ms=timer(lambda: ref.decode_attention(q, kc, vc, pos, t)),
                    library_ms=timer(lambda: F.scaled_dot_product_attention(
                        qx, kx, vx, attn_mask=mask, enable_gqa=True)),
                    flops=flops, bytes=byts, **bound(flops, byts, dn))
            emit(rec)
        decode_edge_check(torch, np, dtype, HYBRID_DECODE_EDGE_CASES,
                          "HYBRID_DECODE_EDGE_CASES", seed=13)
    return {"linear_scan": scan}


# ---------------------------------------------------------------------------
# small model: kernels on the card against the plain path on the CPU
# ---------------------------------------------------------------------------

def paged_steps(torch, np, m, toks, length, tok):
    """The paged LM methods on the small model: a monolithic prefill of
    two rows sharing their first block, a third row ingested in spans of
    8, then decode steps unfused and fused with one row held back.
    Returns every logits tensor and the final pool and positions."""
    dev = toks.device
    bs, n_blocks = 4, 24
    tables = torch.tensor([[3, 7, 1, 9, 12, 13, 20, 21],
                           [3, 5, 11, 14, 15, 16, 22, -1],
                           [2, 4, 6, 8, 10, 17, 18, 19]], dtype=torch.int32, device=dev)
    cache = m.init_paged_cache(3, n_blocks, bs)
    s = toks.shape[1]
    rows = toks[:2].clone()
    rows[1, :bs] = rows[0, :bs]
    e = torch.arange(s, device=dev) // bs
    dest = tables[:2].gather(1, e[None].expand(2, -1).long())
    dest[1, :bs] = -1                                   # slot 1 shares slot 0's block
    logits, cache = m.prefill_paged(rows, cache, dest, torch.tensor([0, 1], device=dev),
                                    length=length[:2])
    out = [logits]
    c = 8
    for begin in range(0, s, c):
        span = toks[2:3, begin:begin + c]
        d = tables[2:3].gather(1, (torch.arange(begin, begin + c, device=dev) // bs)[None].long())
        logits, cache = m.prefill_chunk_paged(
            span, cache, tables[2:3], d, torch.tensor([2], device=dev),
            torch.tensor([begin], dtype=torch.int32, device=dev),
            torch.tensor([c], dtype=torch.int32, device=dev))
        out.append(logits)
    for step in range(4):
        active = torch.tensor([True, step >= 2, True], device=dev)
        logits, cache = m.decode_step_paged(tok[:3], cache, tables, active,
                                            fused_tail=step % 2 == 1)
        out.append(logits)
    return [x.float().cpu() for x in out] + [cache["k_pool"].cpu(), cache["t"].cpu()]


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
        out[name] += paged_steps(torch, np, m, toks.to(dev), length.to(dev), tok.to(dev))
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


def small_hybrid_phase(torch, np):
    """The reduced RG-LRU hybrid, card against CPU: pattern (rec, rec,
    local) with a remainder (5 layers), head_dim 256 over one kv head, a
    local window of 8 under a prompt of 24; ring prefill, then decode
    steps with one row held back.  Compares logits, the local layers'
    K/V and positions and the recurrent layers' h and conv state."""
    import dataclasses
    from repro_torch.configs import get_model_config, reduced
    from repro_torch.data import tokenizer
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(reduced(get_model_config("recurrentgemma-9b")),
                              vocab_size=tokenizer.VOCAB_SIZE, n_layers=5,
                              block_pattern=("rec", "rec", "local"), n_heads=2, n_kv_heads=1,
                              head_dim=256, d_model=128, d_ff=256, lru_width=128,
                              local_window=8)
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gpu = build_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    require(gpu.n_rec == 4 and gpu.n_attn == 1, f"layer kinds {gpu.kinds}")
    rng = np.random.default_rng(4)
    b, s, max_len = 4, 24, 32
    toks = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(b, s)))
    length = torch.tensor([24, 17, 9, 1], dtype=torch.int32)
    tok = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(b,)))
    out = {}
    for name, m in (("cpu", cpu), ("cuda", gpu)):
        dev = m.device
        cache = m.init_cache(b, max_len)
        logits, cache = m.prefill(toks.to(dev), cache, length=length.to(dev))
        steps = [logits]
        active = torch.tensor([True, True, False, True], device=dev)
        for _ in range(4):
            logits, cache = m.decode_step(tok.to(dev), cache, active)
            steps.append(logits)
        out[name] = [x.float().cpu() for x in steps] + [
            cache[k].cpu() for k in ("k", "v", "pos", "h", "conv", "t")]
    tol = 1e-3   # f32 on both sides; other libraries, other summation orders
    err = 0.0
    for a, c in zip(out["cpu"], out["cuda"]):
        if a.dtype == torch.int32:
            require(torch.equal(a, c), "cache positions differ between the card and the CPU")
            continue
        e = (a - c).abs().max().item()
        require(e <= tol + tol * a.abs().max().item(), f"small hybrid: card vs CPU max abs err {e}")
        err = max(err, e)
    emit({"phase": "small", "config": f"{cfg.name} {cfg.block_pattern} x {cfg.n_layers}",
          "head_dim": cfg.head_dim, "n_kv_heads": cfg.n_kv_heads,
          "local_window": cfg.local_window, "max_abs_err": err, "tol": tol})


# ---------------------------------------------------------------------------
# the serving path at full width
# ---------------------------------------------------------------------------

def build_models(torch):
    """areal-qwen-1.5b at full width in bf16: random weights from seed 0,
    and the perturbed policy of version 1 (every weight times 1.01)."""
    from repro_torch.configs import get_model_config
    from repro_torch.models.model import build_model

    cfg = get_model_config("areal-qwen-1.5b")
    t0 = time.perf_counter()
    m0 = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    m0.init(torch.Generator(device="cuda").manual_seed(0))
    m1 = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        for p1, p0 in zip(m1.parameters(), m0.parameters()):
            p1.copy_(p0 * 1.01)
    torch.cuda.synchronize()
    return {"cfg": cfg, "m0": m0, "m1": m1, "init_s": time.perf_counter() - t0,
            "params": sum(p.numel() for p in m0.parameters())}


def check_finished(cfg, done, n: int) -> None:
    """Every request finished with finite logprobs <= 0, tokens in the
    vocabulary, and at least one trajectory spans versions 0 and 1."""
    require(len(done) == n, f"finished {len(done)} of {n}")
    require(any(set(f.versions) == {0, 1} for f in done.values()),
            "no trajectory spans versions 0 and 1")
    for f in done.values():
        require(len(f.response) == len(f.logprobs) == len(f.versions) >= 1, f"rid {f.rid}")
        require(all(math.isfinite(x) and x <= 1e-6 for x in f.logprobs),
                f"rid {f.rid}: a logprob is not finite or above 0")
        require(all(0 <= x < cfg.vocab_size for x in f.response),
                f"rid {f.rid}: a token outside the vocabulary")
        require(f.versions == sorted(f.versions), f"rid {f.rid}: versions out of order")


def require_launches(launches, want) -> None:
    for name, n in want.items():
        require(launches[name] == n, f"{name} launched {launches[name]} times, expected {n}")


def serve_phase(torch, np, models):
    from repro_torch.core.config import EngineConfig
    from repro_torch.core.rollout import RolloutEngine
    from repro_torch.kernels import ops

    cfg, m0, m1 = models["cfg"], models["m0"], models["m1"]
    n_slots, prompt_len, max_gen_len, interrupt_at = 8, 512, 256, 96
    # the engine owns its model and copies updates into it: a copy of m0,
    # so that m0 keeps version 0's weights for the phases after this one
    engine = RolloutEngine(copy.deepcopy(m0), EngineConfig(
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
    check_finished(cfg, done, n_slots)
    n_layers = cfg.n_layers
    require_launches(launches, {"flash_attention": n_layers * prefill_calls,
                                "decode_attention": n_layers * decode_steps,
                                "paged_decode_attention": 0, "paged_prefill_attention": 0,
                                "fused_decode_tail": 0, "flash_attention_bwd": 0})
    st = engine.stats()
    decode_s = sum(step_ms) / 1e3
    rec = {"phase": "serve", "model": cfg.name, "params": models["params"],
           "dtype": "bfloat16", "n_slots": n_slots, "prompt_len": prompt_len,
           "max_gen_len": max_gen_len, "prompt_lengths": [int(x) for x in lengths],
           "init_s": models["init_s"],
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


def serve_paged_phase(torch, np, models, fused: bool):
    """The paged engine at full width.  ``fused``: chunked prefill of 128
    tokens and the fused decode tail (phase ``serve_paged``); else
    monolithic paged prefill through flash attention and the unfused
    paged decode (phase ``serve_paged_unfused``).  Two prompts of 256-512
    tokens are each sampled 4 times, so the group's full prompt blocks are
    shared; a weight update after 96 decode steps re-ingests every history
    under version 1."""
    from repro_torch.core.config import EngineConfig
    from repro_torch.core.rollout import RolloutEngine
    from repro_torch.kernels import ops

    cfg, m0, m1 = models["cfg"], models["m0"], models["m1"]
    name = "serve_paged" if fused else "serve_paged_unfused"
    n_slots, group, max_gen_len, interrupt_at = 8, 4, 256, 96
    ecfg = EngineConfig(n_slots=n_slots, prompt_len=512, max_gen_len=max_gen_len,
                        cache="paged", block_size=16, prefill_chunk=128 if fused else 0,
                        fused_decode="fused" if fused else None, evict="lru",
                        temperature=1.0, seed=0, dtype=torch.bfloat16)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(3, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(256, 513, size=n_slots // group)]
    reqs = [{"rid": g * group + k, "prompt_id": g, "answer": None, "prompt": p}
            for g, p in enumerate(prompts) for k in range(group)]

    # lazy set-up of this path (allocator pools, cuBLAS heuristics of its
    # shapes) is paid on a throwaway engine and reported
    t0 = time.perf_counter()
    warm = RolloutEngine(m0, ecfg)
    warm.admit(reqs[:2])
    while warm.stats()["tokens_generated"] < 4:
        warm.step()
    del warm
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    engine = RolloutEngine(copy.deepcopy(m0), ecfg)     # m0 keeps version 0's weights
    ingests = {"calls": 0}
    ingest_one = engine._ingest_one_chunk

    def counted_ingest():                   # counts the spans the engine feeds
        ingests["calls"] += 1
        ingest_one()
    engine._ingest_one_chunk = counted_ingest

    ops.reset_launches()
    t_admit = time.perf_counter()
    admitted = engine.admit(reqs)
    torch.cuda.synchronize()
    admit_ms = 1e3 * (time.perf_counter() - t_admit)
    prefill_calls = 0 if fused else 1
    decode_ms, mixed_ms = [], []
    admission_ingest_ms = None if fused else admit_ms
    reingest_ms = t_update = None
    blocks_peak = engine.blocks_in_use()
    done = {}
    while len(done) < n_slots:
        if engine.decode_dispatches == interrupt_at and t_update is None:
            t_update = time.perf_counter()
            require(engine.update_weights(m1, version=1), "update_weights was deferred")
            if not fused:
                torch.cuda.synchronize()
                reingest_ms = 1e3 * (time.perf_counter() - t_update)
                prefill_calls += 1
        n_ingest, n_decode = ingests["calls"], engine.decode_dispatches
        t0 = time.perf_counter()
        fin = engine.step()
        torch.cuda.synchronize()
        dt = 1e3 * (time.perf_counter() - t0)
        if ingests["calls"] > n_ingest:
            mixed_ms.append(dt)
        elif engine.decode_dispatches > n_decode:
            decode_ms.append(dt)
        if fused and not engine._ingest_queue:
            if admission_ingest_ms is None:
                admission_ingest_ms = 1e3 * (time.perf_counter() - t_admit)
            if t_update is not None and reingest_ms is None:
                reingest_ms = 1e3 * (time.perf_counter() - t_update)
        blocks_peak = max(blocks_peak, engine.blocks_in_use())
        for f in fin:
            done[f.rid] = f
        require(len(decode_ms) + len(mixed_ms) < 3 * max_gen_len, "requests did not finish")
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    require(admitted == n_slots, f"admitted {admitted} of {n_slots}")
    check_finished(cfg, done, n_slots)
    st = engine.stats()
    require(st["prefix_reused_blocks"] > 0, "no prompt block was shared")
    L = cfg.n_layers
    decode_steps = st["decode_dispatches"]
    if fused:
        want = {"paged_prefill_attention": L * ingests["calls"],
                "fused_decode_tail": L * decode_steps, "flash_attention": 0,
                "decode_attention": 0, "paged_decode_attention": 0}
    else:
        want = {"flash_attention": L * prefill_calls, "paged_decode_attention": L * decode_steps,
                "paged_prefill_attention": 0, "fused_decode_tail": 0, "decode_attention": 0}
    want["flash_attention_bwd"] = 0
    require_launches(launches, want)
    steps = decode_ms + mixed_ms
    rec = {"phase": name, "model": cfg.name, "dtype": "bfloat16",
           "engine": {k: v for k, v in vars(ecfg).items() if k not in ("dtype", "continuation")},
           "prompt_lengths": [len(p) for p in prompts], "group": group,
           "warmup_s": warmup_s, "admit_ms": admit_ms,
           "admission_ingest_ms": admission_ingest_ms, "reingest_ms": reingest_ms,
           "ingest_calls": ingests["calls"], "prefill_calls": prefill_calls,
           "decode_steps": decode_steps, "steps": len(steps),
           "decode_only_step_ms_mean": sum(decode_ms) / len(decode_ms),
           "decode_only_step_ms_median": sorted(decode_ms)[len(decode_ms) // 2],
           "steps_with_ingest": len(mixed_ms),
           "step_with_ingest_ms_mean": sum(mixed_ms) / len(mixed_ms) if mixed_ms else None,
           "generated_tokens_per_s": st["tokens_generated"] / (sum(steps) / 1e3),
           "peak_memory_gb": peak_gb, "blocks_in_use_peak": blocks_peak,
           "pool_blocks": engine.n_blocks, "launches": launches, "stats": st,
           "versions_spanned": sum(set(f.versions) == {0, 1} for f in done.values())}
    emit(rec)
    return launches, engine, reqs, rec["decode_only_step_ms_mean"]


def build_hybrid_models(torch):
    """recurrentgemma-9b at full width in bf16: random weights from seed
    0, and the perturbed policy of version 1 (every weight times 1.01;
    ``lam`` stays f32)."""
    from repro_torch.configs import get_model_config
    from repro_torch.models.model import build_model

    cfg = get_model_config("recurrentgemma-9b")
    t0 = time.perf_counter()
    m0 = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    m0.init(torch.Generator(device="cuda").manual_seed(0))
    m1 = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        for p1, p0 in zip(m1.parameters(), m0.parameters()):
            p1.copy_(p0 * 1.01)
    torch.cuda.synchronize()
    require(m0.blocks[0].rec.lam.dtype == torch.float32, "lam is not f32 in the bf16 model")
    return {"cfg": cfg, "m0": m0, "m1": m1, "init_s": time.perf_counter() - t0,
            "params": sum(p.numel() for p in m0.parameters()),
            "weight_gb": sum(p.numel() * p.element_size() for p in m0.parameters()) / 1e9}


def serve_hybrid_phase(torch, np, models):
    """``serve``'s traffic and interruption on recurrentgemma-9b: 8
    prompts of 256-512 tokens, 256 generated tokens each, one
    interrupting ``update_weights`` after 96 decode steps.  Every prefill
    call runs the linear scan once per RG-LRU layer and flash attention
    once per local layer; every decode step runs decode attention once
    per local layer."""
    from repro_torch.core.config import EngineConfig
    from repro_torch.core.rollout import RolloutEngine
    from repro_torch.kernels import ops

    cfg, m0, m1 = models["cfg"], models["m0"], models["m1"]
    n_slots, prompt_len, max_gen_len, interrupt_at = 8, 512, 256, 96
    ecfg = EngineConfig(n_slots=n_slots, prompt_len=prompt_len, max_gen_len=max_gen_len,
                        temperature=1.0, seed=0, dtype=torch.bfloat16)
    rng = np.random.default_rng(5)
    lengths = rng.integers(256, prompt_len + 1, size=n_slots)
    reqs = [{"rid": i, "prompt_id": i, "answer": None,
             "prompt": rng.integers(3, cfg.vocab_size, size=int(n)).tolist()}
            for i, n in enumerate(lengths)]
    t0 = time.perf_counter()
    warm = RolloutEngine(m0, ecfg)
    warm.admit(reqs)
    for _ in range(2):
        warm.step()
    del warm
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    engine = RolloutEngine(m0, ecfg)
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
        require(decode_steps <= max_gen_len + 1, "requests did not finish")
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    require(admitted == n_slots, f"admitted {admitted} of {n_slots}")
    check_finished(cfg, done, n_slots)
    require((m0.n_rec, m0.n_attn) == (26, 12), f"layer kinds {m0.kinds}")
    require_launches(launches, {"linear_scan": m0.n_rec * prefill_calls,
                                "flash_attention": m0.n_attn * prefill_calls,
                                "decode_attention": m0.n_attn * decode_steps,
                                "paged_decode_attention": 0, "paged_prefill_attention": 0,
                                "fused_decode_tail": 0, "flash_attention_bwd": 0})
    st = engine.stats()
    rec = {"phase": "serve_hybrid", "model": cfg.name, "params": models["params"],
           "weight_gb": models["weight_gb"], "dtype": "bfloat16",
           "layers": {"rec": m0.n_rec, "local": m0.n_attn}, "n_slots": n_slots,
           "prompt_len": prompt_len, "max_gen_len": max_gen_len,
           "prompt_lengths": [int(x) for x in lengths], "init_s": models["init_s"],
           "warmup_s": warmup_s, "prefill_ms": prefill_ms, "reprefill_ms": reprefill_ms,
           "decode_steps": decode_steps, "prefill_calls": prefill_calls,
           "decode_step_ms_mean": sum(step_ms) / len(step_ms),
           "decode_step_ms_median": sorted(step_ms)[len(step_ms) // 2],
           "decode_step_ms_p95": sorted(step_ms)[int(0.95 * len(step_ms))],
           "generated_tokens_per_s": st["tokens_generated"] / (sum(step_ms) / 1e3),
           "peak_memory_gb": peak_gb, "launches": launches, "stats": st,
           "versions_spanned": sum(set(f.versions) == {0, 1} for f in done.values())}
    emit(rec)
    return launches, engine, reqs, rec["decode_step_ms_mean"], prefill_ms


# ---------------------------------------------------------------------------
# the trainer's path: the flash backward kernel, a laptop-scale train step
# against the CPU, and train steps at full width fed by the ring engine
# ---------------------------------------------------------------------------

# b, s, h, hkv, hd of the train phase's micro-batch: one packed row of
# 6144 tokens holding 8 segments of 727 (471 + 256), then padding
TRAIN_SHAPE = (1, 6144, 12, 2, 128)
TRAIN_SEGMENTS = [727] * 8
# the kernel's cases: B x S x (H, Hkv) x head_dim, each causal, causal with
# a window and non-causal, all over packed segments with a -1 tail
BWD_SHAPES = [(b, s, h, hkv, hd) for hd in (64, 128) for b in (1, 4) for s in (1, 37, 256, 768)
              for h, hkv in ((4, 2), (12, 2))]
BWD_VARIANTS = (("causal", True, 0), ("window", True, 100), ("full", False, 0))


def bwd_inputs(torch, np, rng, dtype, b, s, h, hkv, hd, seg_lens=None):
    """q, k, v, dout and packed segment ids: segments of random lengths
    then a -1 padding tail (``seg_lens`` fixes the segments' lengths)."""
    x = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to("cuda", dtype)
         for shape in ((b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd), (b, s, h, hd))]
    seg = np.full((b, s), -1, np.int32)
    for r in range(b):
        lens = seg_lens or rng.integers(1, max(2, s // 2), size=4).tolist()
        o = 0
        for i, n in enumerate(lens):
            n = min(n, s - o)
            seg[r, o:o + n] = i
            o += n
    return (*x, torch.from_numpy(seg).to("cuda"))


def bwd_flops_bytes(torch, seg, s, h, window, causal, q, k, grads):
    """Operations and bytes the backward must do at these inputs: five
    products of 2·hd flops per visible (query, key) pair (S and dP
    recomputed, dV, dK, dQ: 2.5x the forward's two), and q, k, v, out,
    dout, lse and seg read once, dq, dk, dv written once (v as large as k)."""
    mask = flash_mask(torch, seg, s, window, causal)
    flops = 10.0 * q.shape[-1] * mask.sum().item() * h
    byts = 3 * nbytes(q) + 2 * nbytes(k) + nbytes(seg) + 4 * q.shape[0] * h * s + \
        nbytes(*grads)
    return mask, flops, byts


def train_forward(torch, F, timer, q, k, v, seg, mask, kw, case, iters):
    """The flash forward with its log-sum-exp at the train phase's packed
    row, against its plain version, timed beside SDPA's forward with the
    same bool mask.  Its bound: two products of 2·hd flops per visible
    pair; q, k, v and seg read once, out and lse written once."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    b, s, h, hd = q.shape
    out, _ = flash_attention_cuda(q, k, v, seg, return_lse=True, **kw)
    err = check("flash_attention", out, ref.flash_attention(q, k, v, segment_ids=seg, **kw),
                "bfloat16", case)
    flops = 4.0 * hd * mask.sum().item() * h
    byts = 2 * nbytes(q) + 2 * nbytes(k) + nbytes(seg) + 4 * b * h * s
    qx, kx, vx = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qx, kx, vx, attn_mask=mask, enable_gqa=True)
    return {"phase": "train_kernel", "name": "flash_attention", "dtype": "bfloat16",
            "case": f"{case}, forward with its log-sum-exp", "max_abs_err": err,
            "ms": timer(lambda: flash_attention_cuda(q, k, v, seg, return_lse=True, **kw),
                        *iters),
            "library_ms": timer(sdpa, *iters), "flops": flops, "bytes": byts,
            **bound(flops, byts, "bfloat16")}


def train_kernel_phase(torch, np, quick: bool):
    """The flash-attention backward kernel against its plain version over
    ``BWD_SHAPES`` x ``BWD_VARIANTS`` in f32 and bf16, with the forward's
    log-sum-exp against its plain version; every call twice, bitwise
    equal.  Each case is timed beside the plain backward and SDPA's
    backward; the train phase's micro-batch (``TRAIN_SEGMENTS`` packed in
    one row) is timed longer and gives the kernels line its row.  Every
    gradient is held element by element (``check``) and by its
    norm-relative error, whole and per head (``check_norm``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda

    rng = np.random.default_rng(20)
    timer = None if quick else Timer(torch)
    cases = [(dt, shape, v) for dt in (torch.float32, torch.bfloat16) for shape in BWD_SHAPES
             for v in BWD_VARIANTS]
    cases.append((torch.bfloat16, TRAIN_SHAPE, ("train", True, 0)))
    row = None
    worst, worst_norm = {}, {}
    for dtype, (b, s, h, hkv, hd), (variant, causal, window) in cases:
        dn = str(dtype).split(".")[1]
        train = variant == "train"
        q, k, v, dout, seg = bwd_inputs(torch, np, rng, dtype, b, s, h, hkv, hd,
                                        TRAIN_SEGMENTS if train else None)
        kw = dict(causal=causal, window=window)
        case = f"B={b} S={s} H={h} Hkv={hkv} hd={hd} {variant}"
        out, lse = flash_attention_cuda(q, k, v, seg, return_lse=True, **kw)
        got = flash_attention_bwd_cuda(q, k, v, out, lse, dout, seg, **kw)
        again = flash_attention_bwd_cuda(q, k, v, out, lse, dout, seg, **kw)
        want_lse = ref.flash_attention_lse(q, k, segment_ids=seg, **kw)
        want = ref.flash_attention_bwd(q, k, v, out, want_lse, dout, segment_ids=seg, **kw)
        torch.cuda.synchronize()
        err = check("flash_attention lse", lse, want_lse, dn, case)
        for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
            require(torch.equal(g, a), f"flash_attention_bwd {case} {dn}: {name} differs "
                                       "between two calls")
            err = max(err, check(f"flash_attention_bwd {name}", g, w, dn, case))
            worst_norm[dn] = max(worst_norm.get(dn, 0.0),
                                 check_norm(f"flash_attention_bwd {name}", g, w, dn, case))
        worst[dn] = max(worst.get(dn, 0.0), err)
        if timer is None:
            continue
        mask, flops, byts = bwd_flops_bytes(torch, seg, s, h, window, causal, q, k, got)
        iters = (20, 3) if train else (5, 1)
        qx, kx, vx = (x.detach().transpose(1, 2).requires_grad_(True) for x in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qx, kx, vx, attn_mask=mask, enable_gqa=True)
        dx = dout.transpose(1, 2)
        rec = {"phase": "train_kernel", "name": "flash_attention_bwd", "dtype": dn,
               "case": case, "max_abs_err": err, "tol": TOL[dn],
               "norm_rel_err": {n: rms_rel(g, w) for n, g, w in zip(("dq", "dk", "dv"),
                                                                   got, want)},
               "norm_tol": NORM_TOL[dn],
               "median_abs_want": {n: w.float().abs().median().item()
                                   for n, w in zip(("dq", "dk", "dv"), want)},
               "ms": timer(lambda: flash_attention_bwd_cuda(q, k, v, out, lse, dout, seg, **kw),
                           *iters),
               "plain_ms": timer(lambda: ref.flash_attention_bwd(
                   q, k, v, out, lse, dout, segment_ids=seg, **kw), *iters),
               "library_ms": timer(lambda: torch.autograd.grad(
                   sdpa, (qx, kx, vx), dx, retain_graph=True), *iters),
               "flops": flops, "bytes": byts, **bound(flops, byts, dn)}
        emit(rec)
        if train:
            row = rec
            emit(train_forward(torch, F, timer, q, k, v, seg, mask, kw, case, iters))
        del sdpa, mask, qx, kx, vx
    emit({"phase": "train_kernel", "name": "flash_attention_bwd",
          "cases": f"{len(cases)}: BWD_SHAPES x BWD_VARIANTS in f32 and bf16, and the train "
                   "shape; twice bitwise equal", "max_abs_err": worst, "tol": TOL,
          "max_norm_err_over_limit": worst_norm, "norm_tol": NORM_TOL})
    return {"flash_attention_bwd": row} if row else {}


def make_trajectories(finished, rewards):
    """Trajectories of engine results, rewards given by rid."""
    from repro_torch.core.buffer import Trajectory
    return [Trajectory(rid=f.rid, prompt_id=f.prompt_id, prompt_tokens=list(f.prompt),
                       response_tokens=list(f.response), behav_logprobs=list(f.logprobs),
                       versions=list(f.versions), behavior_version=f.behavior_version,
                       reward=rewards[f.rid])
            for f in sorted(finished.values(), key=lambda f: f.rid)]


def group_rewards(rng, rids, group: int):
    """Seeded 0/1 rewards with both values in every group: with random
    weights the verifier would score every answer 0, the group
    advantages would be 0 and the policy gradient would vanish."""
    out = {}
    for g in range(0, len(rids), group):
        r = rng.integers(0, 2, size=group)
        r[0], r[1] = 1, 0
        out.update({rid: float(x) for rid, x in zip(rids[g:g + group], rng.permutation(r))})
    return out


def small_train_phase(torch, np):
    """One train_step of the reduced areal-qwen-1.5b (2 layers, d 256,
    hd 64) in f32 on the card and on the CPU, from the same weights and
    the same trajectories: loss, diagnostics and gradient norms within
    1e-4 relative (f32 on both sides; other libraries and summation
    orders through two layers), updated weights within 1e-2 · lr (Adam's
    first step is about lr · sign(g); where |g| is near its eps the step
    follows g's rounding).  The card's launches: flash forward 2 layers x
    2 x micro-batches (prox, then the loss), backward 2 x micro-batches."""
    import dataclasses
    from repro_torch.configs import get_model_config, reduced
    from repro_torch.configs.base import RLConfig
    from repro_torch.core.buffer import Trajectory
    from repro_torch.core.trainer import PPOTrainer
    from repro_torch.data import tokenizer
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(reduced(get_model_config("areal-qwen-1.5b")),
                              vocab_size=tokenizer.VOCAB_SIZE)
    rl = RLConfig(batch_size=8, answers_per_prompt=4, ppo_minibatches=2,
                  microbatch_token_budget=96, lr=1e-3, warmup_proportion=0.0)
    rng = np.random.default_rng(7)
    rewards = group_rewards(rng, list(range(8)), 4)
    lens = rng.integers(8, 40, size=8)
    trajs = [Trajectory(rid=i, prompt_id=i // 4, behavior_version=0,
                        prompt_tokens=rng.integers(3, cfg.vocab_size, 20).tolist(),
                        response_tokens=rng.integers(3, cfg.vocab_size, int(n)).tolist(),
                        behav_logprobs=(-4 * rng.random(int(n))).tolist(),
                        versions=[0] * int(n), reward=rewards[i])
             for i, n in enumerate(lens)]
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gpu = build_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    res = {}
    for name, m in (("cpu", cpu), ("cuda", gpu)):
        trainer = PPOTrainer(m, rl)
        ops.reset_launches()
        met = trainer.train_step(trajs)
        res[name] = (met, [x["grad_norm"] for x in trainer.opt_metrics],
                     [p.detach().cpu() for p in m.parameters()], dict(ops.LAUNCHES))
    (mc, nc, pc, _), (mg, ng, pg, launches) = res["cpu"], res["cuda"]
    n_mb = mg.n_microbatches
    require_launches(launches, {"flash_attention": cfg.n_layers * 2 * n_mb,
                                "flash_attention_bwd": cfg.n_layers * n_mb})
    tol = 1e-4
    pairs = [("loss", mc.loss, mg.loss)] + [(k, mc.diag[k], mg.diag[k]) for k in mc.diag] + \
        [(f"grad_norm[{i}]", a, b) for i, (a, b) in enumerate(zip(nc, ng))]
    err = 0.0
    for name, a, b in pairs:
        require(math.isfinite(b) and abs(a - b) <= tol * max(abs(a), 1e-3),
                f"small_train {name}: card {b} vs CPU {a}")
        err = max(err, abs(a - b) / max(abs(a), 1e-3))
    perr = max((a - b).abs().max().item() for a, b in zip(pc, pg))
    require(perr <= 1e-2 * rl.lr, f"small_train: updated weights differ by {perr}")
    require(mg.n_microbatches == mc.n_microbatches >= 2, "micro-batches differ")
    emit({"phase": "small_train", "config": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "head_dim": cfg.head_dim, "n_microbatches": n_mb,
          "loss": mg.loss, "grad_norms": ng, "max_rel_err": err, "tol": tol,
          "param_max_abs_err": perr, "param_tol": 1e-2 * rl.lr, "launches": launches})


def engine_probe(torch, engine):
    """The engine's logits of a fixed prompt, from its own model: one
    prefill, so one flash launch a layer (counted with the phase's)."""
    cache = engine.model.init_cache(1, 16, engine.dtype)
    toks = torch.arange(3, 15, device=engine.device)[None]
    return engine.model.prefill(toks, cache)[0]


def generate(engine, reqs, update=None):
    """Admit ``reqs`` and step until they finish; ``update`` = (step, fn)
    runs fn before that decode step.  Returns (finished by rid, decode
    steps, prefill calls)."""
    done, steps, prefills = {}, 0, 0
    if reqs:
        require(engine.admit(reqs) == len(reqs), "the engine did not take every request")
        prefills += 1
    while engine.n_active:
        if update is not None and steps == update[0]:
            update[1]()
            prefills += 1
        for f in engine.step():
            done[f.rid] = f
        steps += 1
        require(steps <= 2 * engine.max_gen_len, "requests did not finish")
    return done, steps, prefills


def train_phase(torch, np, profile: bool):
    """areal-qwen-1.5b at full width: a bf16 policy (m and v f32) behind
    the PPO trainer, and a copy of its initial weights behind the ring
    engine (bf16), which serves ``serve_paged``'s two prompts (471 and 323
    tokens) 16 times each (the reference's answers per prompt), 256 tokens
    per answer.  Algorithm 1 packs the 32 sequences of 727 and 579 tokens
    into micro-batches of 6144 (8 x 768) tokens, 6 to 10 segments in one
    row, two per PPO minibatch.  Rewards: seeded 0/1, both in each group.
    train_step on that batch; a second batch is
    admitted and decoded 64 steps; ``update_weights(trainer.params, 1)``
    interrupts it, and it finishes under version 1; a second train_step
    on it.  Every flash forward and backward of a train step is 28 x its
    calls; after the hand-off, the trainer's in-place updates never reach
    the engine's logits."""
    import dataclasses as _dc
    from repro_torch.configs import get_model_config
    from repro_torch.configs.base import RLConfig
    from repro_torch.core import batching
    from repro_torch.core.config import EngineConfig
    from repro_torch.core.rollout import RolloutEngine
    from repro_torch.core.trainer import PPOTrainer
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model

    cfg = get_model_config("areal-qwen-1.5b")
    L = cfg.n_layers
    t0 = time.perf_counter()
    policy = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    policy.init(torch.Generator(device="cuda").manual_seed(0))
    serving = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    serving.load_state_dict(policy.state_dict())
    group = 16
    rl = RLConfig(batch_size=2, answers_per_prompt=group, ppo_minibatches=2,
                  microbatch_token_budget=6144)
    trainer = PPOTrainer(policy, rl)
    n_req = 2 * group
    engine = RolloutEngine(serving, EngineConfig(n_slots=n_req, prompt_len=512, max_gen_len=256,
                                                 temperature=1.0, seed=0,
                                                 dtype=torch.bfloat16))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(2)                # serve_paged's prompts
    prompts = [rng.integers(3, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(256, 513, size=2)]
    batch_reqs = [[{"rid": off + g * group + j, "prompt_id": off + g, "answer": None,
                    "prompt": p} for g, p in enumerate(prompts) for j in range(group)]
                  for off in (0, n_req)]
    rrng = np.random.default_rng(3)
    torch.cuda.reset_peak_memory_stats()

    steps = []

    def timed_step(trajs, version):
        before = dict(ops.LAUNCHES)
        t = time.perf_counter()
        met = trainer.train_step(trajs, current_version=version)
        ms = 1e3 * (time.perf_counter() - t)
        calls = {n: ops.LAUNCHES[n] - before[n] for n in ops.LAUNCHES}
        n_mb = met.n_microbatches
        require_launches(calls, {"flash_attention": L * 2 * n_mb,
                                 "flash_attention_bwd": L * n_mb, "decode_attention": 0})
        tm = trainer.timings
        norms = [m["grad_norm"] for m in trainer.opt_metrics]
        require(math.isfinite(met.loss) and all(math.isfinite(v) for v in met.diag.values()),
                f"train_step: loss {met.loss} or a diagnostic is not finite")
        require(all(math.isfinite(g) and g > 0 for g in norms), f"grad norms {norms}")
        segments = [len(g) for g in batching.dynamic_batching(
            [min(t.length, rl.microbatch_token_budget) for t in trajs],
            rl.microbatch_token_budget, rl.min_microbatches)]
        require(len(segments) == n_mb and min(segments) >= 2,
                f"micro-batches of {segments} sequences: the rows are not packed")
        steps.append({"ms": ms, "prepare_ms": 1e3 * tm["prepare"], "prox_ms": 1e3 * tm["prox"],
                      "segments_per_microbatch": segments,
                      "fwd_bwd_ms": [1e3 * x for x in tm["fwd_bwd"]],
                      "optimizer_ms": [1e3 * x for x in tm["optimizer"]],
                      "n_microbatches": n_mb, "n_tokens": met.n_tokens,
                      "trained_tokens_per_s": met.n_tokens / (ms / 1e3),
                      "loss": met.loss, "diag": met.diag, "grad_norms": norms,
                      "staleness_mean": met.staleness_mean, "launches": calls})
        return met

    ops.reset_launches()
    t = time.perf_counter()
    done1, steps1, prefills1 = generate(engine, batch_reqs[0])
    gen1_s = time.perf_counter() - t
    rewards = group_rewards(rrng, sorted(done1), group)
    before_w = [p.detach().clone() for p in policy.parameters()]
    timed_step(make_trajectories(done1, rewards), 1)
    # every matrix moves; a norm scale of ~1.0 may not: bf16's spacing there
    # (2^-7) is far above a step of lr = 2e-5, in the reference as here
    moved = [not torch.equal(a, b.detach()) for a, b in zip(before_w, policy.parameters())]
    require(all(m for m, p in zip(moved, before_w) if p.dim() >= 2),
            "train_step left a weight matrix unchanged")
    changed = f"{sum(moved)} of {len(moved)} tensors, every matrix"
    del before_w

    probe = {}

    def hand_off():
        require(engine.update_weights(trainer.params, 1), "update_weights was deferred")
        probe["logits"] = engine_probe(torch, engine)
    t = time.perf_counter()
    done2, steps2, prefills2 = generate(engine, batch_reqs[1], update=(64, hand_off))
    gen2_s = time.perf_counter() - t
    require(any(set(f.versions) == {0, 1} for f in done2.values()),
            "no trajectory of the second batch spans versions 0 and 1")
    rewards.update(group_rewards(rrng, sorted(done2), group))
    timed_step(make_trajectories(done2, rewards), 2)
    # the second step changed the trainer's weights in place: not the engine's
    require(torch.equal(engine_probe(torch, engine), probe["logits"]),
            "the trainer's in-place update reached the engine's weights")
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the engine's prefills, then the two engine_probe prefills
    require_launches(launches, {"decode_attention": L * (steps1 + steps2),
                                "flash_attention": L * (prefills1 + prefills2 + 2)
                                + sum(s["launches"]["flash_attention"] for s in steps),
                                "flash_attention_bwd": sum(s["launches"]["flash_attention_bwd"]
                                                           for s in steps),
                                "paged_decode_attention": 0, "paged_prefill_attention": 0,
                                "fused_decode_tail": 0, "linear_scan": 0})
    rec = {"phase": "train", "model": cfg.name, "dtype": "bfloat16", "optimizer_state": "f32",
           "rl": {k: v for k, v in _dc.asdict(rl).items()
                  if k in ("batch_size", "answers_per_prompt", "ppo_minibatches",
                           "microbatch_token_budget", "lr", "clip_eps")},
           "prompt_lengths": [len(p) for p in prompts], "init_s": init_s,
           "generate_s": [gen1_s, gen2_s], "decode_steps": [steps1, steps2],
           "seq_lens": [sorted(len(f.prompt) + len(f.response) for f in d.values())
                        for d in (done1, done2)],
           "versions_spanned": sum(set(f.versions) == {0, 1} for f in done2.values()),
           "train_steps": steps, "params_changed_by_step_1": changed,
           "peak_memory_gb": peak_gb, "launches": launches,
           "hand_off": "engine logits unchanged by the trainer's later in-place update"}
    emit(rec)
    if profile:
        profile_train_phase(torch, trainer, make_trajectories(done2, rewards),
                            steps[-1]["ms"])
    return launches


def profile_train_phase(torch, trainer, trajs, step_ms: float):
    """Device time of one more train_step by kernel kind, from a
    torch.profiler trace, and the share of the unprofiled second step
    (``step_ms``) the card sat idle."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(trajs)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels, busy, by_kind = device_time(torch, prof)
    rec = {"phase": "profile_train", "profiled_wall_ms": wall_ms, "kernels": len(kernels)}
    if kernels:
        rec.update(device_busy_ms=busy / 1e3, device_idle_share=1.0 - busy / 1e3 / step_ms,
                   device_ms_by_kind={k: v / 1e3 for k, v in by_kind.items() if v})
    else:
        rec["device_time"] = "not measured: the profiler recorded no CUDA kernels"
    emit(rec)


KINDS = (("paged_decode_attention", ("paged_decode_kernel",)),
         ("fused_decode_tail", ("fused_decode_tail_",)),
         ("paged_prefill_attention", ("paged_prefill_",)),
         ("flash_attention", ("flash_fwd_",)),
         ("flash_attention_bwd", ("bwd_prep_", "bwd_dkdv_", "bwd_reduce_", "bwd_dq_",
                                  "bwd_kernel")),
         ("decode_attention", ("ring_decode_",)),
         ("linear_scan", ("linear_scan_kernel",)),
         ("matmul", ("gemm", "gemv", "cutlass", "xmma", "nvjet", "cublas")))


def device_time(torch, prof):
    """(kernels, busy us, us by kind) of a torch.profiler trace: the
    union of the kernels' intervals, and their time by ``KINDS``."""
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_kind = {k: 0.0 for k, _ in KINDS}
    by_kind["other"] = 0.0
    spans = []
    for e in kernels:
        spans.append((e.time_range.start, e.time_range.end))
        kind = next((k for k, keys in KINDS if any(s in e.name for s in keys)), "other")
        by_kind[kind] += e.time_range.end - e.time_range.start
    busy, end = 0.0, -math.inf
    for s, e in sorted(spans):               # union of kernel intervals
        if e > end:
            busy += e - max(s, end)
            end = e
    return kernels, busy, by_kind


def profile_phase(torch, name, engine, reqs, step_ms: float, steps: int = 8):
    """Device time of a few decode steps of phase ``name``'s engine by
    kernel kind, from a torch.profiler trace, and the share of an
    unprofiled decode step (``step_ms``, from that phase) that the card
    sat idle; the profiler slows the host, so its own wall time is
    reported apart.  A chunked engine ingests its new prompts first."""
    from torch.profiler import ProfilerActivity, profile

    engine.admit([dict(r, rid=100 + r["rid"]) for r in reqs])
    while engine.ingest_backlog_tokens():
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels, busy, by_kind = device_time(torch, prof)
    rec = {"phase": "profile", "of": name, "decode_steps": steps,
           "profiled_wall_ms_per_step": wall_us / steps / 1e3,
           "kernels_per_step": len(kernels) / steps}
    if kernels:
        rec.update(device_busy_ms_per_step=busy / steps / 1e3,
                   device_idle_share=1.0 - busy / steps / 1e3 / step_ms,
                   device_ms_per_step_by_kind={k: v / steps / 1e3 for k, v in by_kind.items()})
    else:
        rec["device_time"] = "not measured: the profiler recorded no CUDA kernels"
    emit(rec)


def profile_prefill_phase(torch, engine, reqs, prefill_ms: float):
    """Device time of one admission prefill of ``reqs`` into a fresh
    engine of ``engine``'s model and configuration, by kernel kind (the
    linear scan's share of a hybrid prefill), and the share of the
    unprofiled admission (``prefill_ms``) the card sat idle."""
    from repro_torch.core.rollout import RolloutEngine
    from repro_torch.kernels import ops
    from torch.profiler import ProfilerActivity, profile

    fresh = RolloutEngine(engine.model, engine.engine_config)
    torch.cuda.synchronize()
    before = dict(ops.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fresh.admit(reqs)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    scans = ops.LAUNCHES["linear_scan"] - before["linear_scan"]
    kernels, busy, by_kind = device_time(torch, prof)
    rec = {"phase": "profile_prefill", "of": "serve_hybrid", "prefill_rows": len(reqs),
           "profiled_wall_ms": wall_ms, "kernels": len(kernels), "linear_scan_launches": scans}
    if kernels:
        rec.update(device_busy_ms=busy / 1e3, device_idle_share=1.0 - busy / 1e3 / prefill_ms,
                   device_ms_by_kind={k: v / 1e3 for k, v in by_kind.items() if v},
                   linear_scan_share_of_busy=by_kind["linear_scan"] / busy)
    else:
        rec["device_time"] = "not measured: the profiler recorded no CUDA kernels"
    emit(rec)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="environment, build and kernel checks only")
    ap.add_argument("--profile", action="store_true",
                    help="after the serving paths, trace a few decode steps with torch.profiler")
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
                        if any(k in ln for k in ("registers", "spill", "Function properties",
                                                 "Performance Loss", "wgmma", "serializ"))]
                    for n, r in report.items()}})

    # 3. kernels against their plain versions, timed
    timed = kernel_phase(torch, np, args.quick)
    timed.update(paged_kernel_phase(torch, np, args.quick))
    timed.update(hybrid_kernel_phase(torch, np, args.quick))
    timed.update(train_kernel_phase(torch, np, args.quick))
    # 4. small models, card against CPU
    small_phase(torch, np)
    small_hybrid_phase(torch, np)
    small_train_phase(torch, np)
    if not args.quick:
        # 5-7. the serving paths at full width: ring, paged with chunked
        # prefill and the fused tail, paged monolithic and unfused
        models = build_models(torch)
        ring, engine, reqs, step_ms = serve_phase(torch, np, models)
        paged, paged_engine, paged_reqs, paged_ms = serve_paged_phase(torch, np, models,
                                                                       fused=True)
        unfused, unfused_engine, _, unfused_ms = serve_paged_phase(torch, np, models,
                                                                   fused=False)
        if args.profile:
            profile_phase(torch, "serve", engine, reqs, step_ms)
            profile_phase(torch, "serve_paged", paged_engine, paged_reqs, paged_ms)
            profile_phase(torch, "serve_paged_unfused", unfused_engine, paged_reqs, unfused_ms)
        # 8. the RG-LRU hybrid at full width, after the dense models are freed
        del models, engine, paged_engine, unfused_engine
        gc.collect()
        torch.cuda.empty_cache()
        hybrid_models = build_hybrid_models(torch)
        hybrid, hybrid_engine, hybrid_reqs, hybrid_ms, hybrid_prefill_ms = serve_hybrid_phase(
            torch, np, hybrid_models)
        if args.profile:
            profile_phase(torch, "serve_hybrid", hybrid_engine, hybrid_reqs, hybrid_ms)
            profile_prefill_phase(torch, hybrid_engine, hybrid_reqs, hybrid_prefill_ms)
        # 9. the trainer at full width, after the hybrid's models are freed
        del hybrid_models, hybrid_engine
        gc.collect()
        torch.cuda.empty_cache()
        train = train_phase(torch, np, args.profile)
        launches = {"flash_attention": ring["flash_attention"],
                    "decode_attention": ring["decode_attention"],
                    "paged_prefill_attention": paged["paged_prefill_attention"],
                    "fused_decode_tail": paged["fused_decode_tail"],
                    "paged_decode_attention": unfused["paged_decode_attention"],
                    "linear_scan": hybrid["linear_scan"],
                    "flash_attention_bwd": train["flash_attention_bwd"]}
        missing = [n for n, c in launches.items() if not c]
        if missing:
            raise AssertionError(f"kernels never launched on their paths: {missing}")
        rows = []
        for name in REPLACES:
            r = timed[name]
            rows.append({"name": name, "route": "cuda", "source": SOURCES[name],
                         "replaces": REPLACES[name], "launches": launches[name],
                         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                         "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
            if "library" in r:
                rows[-1]["library"] = r["library"]
        emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
