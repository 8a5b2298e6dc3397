#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``hd80_kernel`` and ``sharded`` phases alone on
one NVIDIA H100.

    python3 tools/sharded_phase.py [hd80] [sharded]

Builds the kernels, then runs the named phases (both without arguments),
printing their JSON lines as the full script does.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("sharded_phase.py: no CUDA device is available", file=sys.stderr)
        return 2
    parts = sys.argv[1:] or ["hd80", "sharded"]
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
    for part in parts:
        t0 = time.perf_counter()
        if part == "hd80":
            cs.hd80_kernel_phase(torch, np, False)
        elif part == "sharded":
            cs.sharded_phase(torch, np)
        else:
            raise SystemExit(f"unknown part {part!r}")
        print(f"phase {part}: {time.perf_counter() - t0:.1f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
