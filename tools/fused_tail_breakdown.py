#!/usr/bin/env python3
"""Apportion the fused decode tail's device time on one NVIDIA H100.

    python3 tools/fused_tail_breakdown.py            # seconds
    python3 tools/fused_tail_breakdown.py --engine   # + the fused tail in the engine (a minute)

Times ``repro_torch``'s fused_decode_tail and paged_decode_attention
kernels in bf16 at the paged serving path's shapes (8 slots in groups of
4 sharing their prompt blocks, t in [256, 768), pool (384, 16, 2, 128),
wo 1536 x 1536), with ``chip_smoke.py``'s timer (CUDA events, L2
flushed), under:

  * forced split plans, from one split per (slot, kv head) to the most
    the resident grid takes, for both kernels: the sweep behind
    ``paged_decode_attention.split_plan``'s rule and each kernel's fewest
    tiles per split (SPLIT_TILES);
  * variants that empty a step of the fused tail: t = 0 in every slot
    (step 1 reads one key per slot), wo cut to 64 columns (8 projection
    tiles), and two builds of the kernel with a step taken out, for timing
    only (their outputs are wrong): the projection skipped (its wo tile
    still awaited), the grid-wide barrier skipped, wo never loaded, and
    all three (attention and merge only);

and beside them the unfused pair it stands against (paged decode
attention, the ``wo`` matmul, and both), SDPA over the gathered pool with
and without ``wo``, and the timer's floor (one launch of a one-element
add).  Then, as a decode step meets them: the device time per call that
torch.profiler records for the fused tail and for paged decode + the
``wo`` matmul, over 28 layers each with its own ``wo`` (a QKV-sized
matmul before each call), with one pool shared by every layer ("hot":
its K/V stay in L2) and with a pool per layer ("cold", as in the
engine).  With ``--engine``, also the device time per call of the fused
tail and of those builds inside the paged engine's decode steps
(``chip_smoke.py``'s serve_paged phase at full width, whose own JSON
lines come first).  Prints one JSON object.
"""
from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# text substitutions that take a step out of csrc/fused_decode_tail.cu
NO_PROJECTION = ("        for (int r0 = 0; r0 < B; r0 += 16) {",
                 "        for (int r0 = 0; r0 < 0; r0 += 16) {")
NO_BARRIER = ("    if (tid == 0) count_barrier(grid_count, gbase, gridDim.x);\n"
              "    __syncthreads();\n\n    // out[r0",
              "    __syncthreads();\n\n    // out[r0")
NO_WO = [("        request(blockIdx.x);\n    }\n    split_items<HD>", "    }\n    split_items<HD>"),
         ("        attn::mbar_wait(bar, it & 1);\n", "")]
VARIANTS = {
    "projection skipped": [NO_PROJECTION],
    "grid barrier skipped": [NO_BARRIER],
    "wo not loaded": NO_WO,
    "attention and merge only": [NO_PROJECTION, NO_BARRIER] + NO_WO,
}


def variant_fns(name: str, subs):
    """(capacity, forward) of fused_decode_tail.cu with each (old, new) of
    `subs` replaced."""
    from repro_torch.kernels import build
    source = (build.CSRC / "fused_decode_tail.cu").read_text()
    for old, new in subs:
        if source.count(old) < 1:
            raise RuntimeError(f"variant {name!r}: a substitution no longer matches the source")
        source = source.replace(old, new, 1)      # the bf16 kernel comes first
    lib = build.load_variant("fused_decode_tail_" + name.replace(" ", "_"), source)
    p, i = ctypes.c_void_p, ctypes.c_int
    cap, fwd = lib.fused_decode_tail_capacity, lib.fused_decode_tail_fwd
    cap.argtypes = [i] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fwd.argtypes = [p] * 11 + [i] * 10 + [ctypes.c_float, i, p]
    cap.restype = fwd.restype = ctypes.c_int
    return cap, fwd


def in_engine(torch, np, cs):
    """Device us per call of the fused tail inside `chip_smoke.py`'s
    serve_paged decode steps (4 steps, 28 layers, after the phase and a
    fresh admission), for the kernel and for each of VARIANTS: a variant
    runs first on the layer's inputs and the kernel again after it, for
    the engine's output; only the first call of each pair is counted."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import fused_decode_tail as ft
    from repro_torch.kernels import ops

    models = cs.build_models(torch)
    _, engine, reqs, _ = cs.serve_paged_phase(torch, np, models, fused=True)
    engine.admit([dict(r, rid=100 + r["rid"]) for r in reqs])
    while engine.ingest_backlog_tokens():
        engine.step()
    kept, real = ft._fns(), ops.fused_decode_tail_cuda
    out = {}
    try:
        for name, fns in [("the kernel", kept)] + [(n, variant_fns(n, subs))
                                                   for n, subs in VARIANTS.items()]:
            def first_then_kernel(*args, **kwargs):
                ft._FNS = fns
                try:
                    real(*args, **kwargs)
                finally:
                    ft._FNS = kept
                return real(*args, **kwargs)
            ops.fused_decode_tail_cuda = first_then_kernel
            engine.step()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(4):
                    engine.step()
                torch.cuda.synchronize()
            calls = sorted((e for e in prof.events()
                            if e.device_type == torch.autograd.DeviceType.CUDA
                            and "fused_decode_tail_" in e.name),
                           key=lambda e: e.time_range.start)[0::2]
            out[name] = sum(e.time_range.end - e.time_range.start for e in calls) / len(calls)
    finally:
        ops.fused_decode_tail_cuda = real
    return out


def layer_sequence(torch, cs, np, fused_call, unfused_call, own_pools: bool, layers: int = 28):
    """Device us per call of the fused tail, of paged decode and of the
    wo matmul, from a torch.profiler trace of 3 passes over `layers`
    layers, each with its own wo (bf16, 1536 x 1536) and, with own_pools,
    its own pool of the paged engine's shapes; a matmul of the QKV
    projection's size runs before each call."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(2)
    card = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to("cuda", torch.bfloat16)
    pools = []
    for i in range(layers if own_pools else 1):
        kp, vp, _, _ = cs.engine_pool(np, np.random.default_rng(1), 8, 2, 128, 16, 48, 256, 768)
        pools.append((card(kp), card(vp)))
    wos = [card(rng.standard_normal((1536, 1536), dtype=np.float32) / 40) for _ in range(layers)]
    x = card(rng.standard_normal((8, 1536), dtype=np.float32))
    wqkv = card(rng.standard_normal((1536, 2048), dtype=np.float32) / 40)
    out = {}
    for name, call in (("fused", fused_call), ("unfused", unfused_call)):
        def passes(n):
            for _ in range(n):
                for i in range(layers):
                    torch.matmul(x, wqkv)
                    call(*pools[i % len(pools)], wos[i])
        passes(1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            passes(3)
            torch.cuda.synchronize()
        us = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                kind = ("fused_decode_tail" if "fused_decode_tail_" in e.name else
                        "paged_decode_attention" if "paged_decode_kernel" in e.name else
                        "matmul")
                us[kind] = us.get(kind, 0.0) + e.time_range.end - e.time_range.start
        out[name] = {k: v / (3 * layers) for k, v in us.items()}
    # the wo matmul: the unfused pass runs it beside the QKV-sized one
    out["unfused"]["wo matmul"] = (out["unfused"].get("matmul", 0.0)
                                   - out["fused"].get("matmul", 0.0))
    return out


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("fused_tail_breakdown.py: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import fused_decode_tail as ft
    from repro_torch.kernels import paged_decode_attention as pd

    build.build(["fused_decode_tail", "paged_decode_attention"])
    timer = cs.Timer(torch)
    rng = np.random.default_rng(1)
    b, h, hkv, hd, bs, entries, dm = 8, 12, 2, 128, 16, 48, 1536
    kp, vp, tab, t = cs.engine_pool(np, rng, b, hkv, hd, bs, entries, 256, 768)
    card = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to("cuda", torch.bfloat16)
    ints = lambda x: torch.from_numpy(np.ascontiguousarray(x)).cuda()
    q = card(rng.standard_normal((b, h, hd), dtype=np.float32))
    kp, vp, tab, t = card(kp), card(vp), ints(tab), ints(t)
    wo = card(rng.standard_normal((h * hd, dm), dtype=np.float32) * (h * hd) ** -0.5)
    wo64 = wo[:, :64].contiguous()
    t0 = torch.zeros_like(t)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    cap_pd, cap_ft = pd._capacity(1, hd, q.device), ft._capacity(1, h, hkv, hd, q.device)
    plan = pd.split_plan(b, hkv, entries * bs, n_sm, cap_pd)
    plan_ft = pd.split_plan(b, hkv, entries * bs, n_sm, cap_ft, ft.SPLIT_TILES)
    fused = lambda tt=t, w=wo, n=None: ft.fused_decode_tail_split(q, kp, vp, w, tab, tt, n)
    fused_call = lambda k, v, w: ft.fused_decode_tail_cuda(q, k, v, w, tab, t)
    unfused_call = lambda k, v, w: torch.matmul(
        pd.paged_decode_attention_cuda(q, k, v, tab, t).reshape(b, h * hd), w)
    paged = lambda tt=t, n=None: pd.paged_decode_attention_split(q, kp, vp, tab, tt, n)

    want = fused()
    for n in (1, 2, plan_ft):         # every split plan computes the same function
        torch.testing.assert_close(fused(n=n), want, atol=2e-2, rtol=2e-2)
    sweep = {}
    for n in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48):
        if n == 1 or b * hkv * n <= cap_pd:
            sweep.setdefault(n, {})["paged_decode_attention"] = timer(lambda: paged(n=n),
                                                                      iters=50)
        if n == 1 or b * hkv * n <= cap_ft:
            sweep.setdefault(n, {})["fused_decode_tail"] = timer(lambda: fused(n=n), iters=50)
    kg, vg, kpos = ref.gather_pool(kp, vp, tab)
    qx, kx, vx = q[:, :, None, :], kg.transpose(1, 2), vg.transpose(1, 2)
    mask = cs.decode_mask(kpos, t, 0)[:, None, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(qx, kx, vx, attn_mask=mask, enable_gqa=True)
    one = torch.zeros(1, device="cuda")
    ms = {
        f"fused (the wrapper's plan, {plan_ft} splits)": fused,
        "fused t=0": lambda: fused(tt=t0),
        "fused D=64": lambda: fused(w=wo64),
        "fused D=64 t=0": lambda: fused(tt=t0, w=wo64),
        f"paged_decode_attention (the wrapper's plan, {plan} splits)": paged,
        "paged_decode_attention t=0": lambda: paged(tt=t0),
        "matmul wo": lambda: torch.matmul(q.reshape(b, h * hd), wo),
        "paged_decode_attention + matmul wo": lambda: torch.matmul(
            paged().reshape(b, h * hd), wo),
        "sdpa": sdpa,
        "sdpa + matmul wo": lambda: torch.matmul(sdpa().reshape(b, h * hd), wo),
        "floor (one-element add)": lambda: one.add_(1),
    }
    ms = {name: timer(fn, iters=50) for name, fn in ms.items()}
    kept = ft._fns()
    for name, subs in VARIANTS.items():     # timing only: the outputs are wrong
        ft._FNS = variant_fns(name, subs)
        try:
            ms[f"fused, {name}"] = timer(fused, iters=50)
            ms[f"fused, {name}, t=0"] = timer(lambda: fused(tt=t0), iters=50)
        finally:
            ft._FNS = kept
    profiled = {name: layer_sequence(torch, cs, np, fused_call, unfused_call, own_pools)
                for name, own_pools in (("hot", False), ("cold", True))}
    engine = in_engine(torch, np, cs) if "--engine" in sys.argv[1:] else "not run (--engine)"
    print(json.dumps({"tool": "fused_tail_breakdown", "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": cs.nvidia_smi(),
                      "split_plan": {"paged_decode_attention": plan, "fused_decode_tail": plan_ft},
                      "resident_blocks": {"paged_decode_attention": cap_pd,
                                          "fused_decode_tail": cap_ft},
                      "ms_by_n_split": sweep, "ms": ms,
                      "profiled_us_per_call": profiled,
                      "in_engine_us_per_call": engine}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
