#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s mixture-of-experts and VLM phases alone on one NVIDIA H100.

    python3 tools/moe_phases.py [kernel] [small] [serve] [vlm] [train] [--profile] [--no-fill]

Builds the kernels, then runs the named phases (all five by default),
each printing its JSON lines as the full script does: ``kernel``
(``moe_kernel_phase``), ``small`` (``small_moe_phase``), ``serve``
(``serve_moe_phase``; ``--profile`` traces 8 more ring decode steps),
``vlm`` (``serve_vlm_phase``) and ``train`` (``train_moe_phase``).  A
phase that fails prints its traceback and the script exits 1 after the
others.  ``--no-fill`` instead times ``serve_moe_paged``'s engine
twice with the MoE's empty-row fill (``ops`` ``mean_empty_rows``) and
twice without it, alternating, each with a profile of 8 decode steps:
what the fill costs (the trajectories differ without it).
"""
from __future__ import annotations

import gc
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def fill_ab(torch, np, cs) -> None:
    from repro_torch.kernels import ops

    models = cs.build_moe_models(torch, "olmoe-1b-7b")
    fns = {n: getattr(ops, n) for n in ("paged_decode_attention", "fused_decode_tail",
                                        "paged_prefill_attention")}

    def without(fn):
        return lambda *a, **k: fn(*a, **{**k, "mean_empty_rows": False})
    try:
        for label in ("fill", "nofill", "fill", "nofill"):
            for n, fn in fns.items():
                setattr(ops, n, fn if label == "fill" else without(fn))
            _, eng, reqs, ms = cs.serve_paged_phase(torch, np, models, fused=True,
                                                    name=f"serve_moe_paged_{label}")
            cs.profile_phase(torch, f"serve_moe_paged_{label}", eng, reqs, ms)
            del eng
            torch.cuda.empty_cache()
    finally:
        for n, fn in fns.items():
            setattr(ops, n, fn)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("moe_phases.py: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(cs.nvidia_smi(), torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    build.build()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    if "--no-fill" in sys.argv:
        fill_ab(torch, np, cs)
        return 0
    profile = "--profile" in sys.argv
    phases = {"kernel": lambda: cs.moe_kernel_phase(torch, np, False),
              "small": lambda: cs.small_moe_phase(torch, np),
              "serve": lambda: cs.serve_moe_phase(torch, np, profile),
              "vlm": lambda: cs.serve_vlm_phase(torch, np),
              "train": lambda: cs.train_moe_phase(torch, np)}
    which = [a for a in sys.argv[1:] if not a.startswith("--")] or list(phases)
    unknown = [a for a in which if a not in phases]
    if unknown:
        print(f"moe_phases.py: unknown phases {unknown}; choose from {list(phases)}",
              file=sys.stderr)
        return 2
    ok = True
    for name in which:
        t0 = time.perf_counter()
        try:
            phases[name]()
        except Exception:
            traceback.print_exc()
            ok = False
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
