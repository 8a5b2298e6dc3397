#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``steps`` phase alone on one NVIDIA H100.

    python3 tools/steps_phase.py

Builds the kernels, then runs ``steps_phase`` (the production step
functions beside the dry run's predictions, and its part ``hybrid``),
printing its JSON lines as the full script does.
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
        print("steps_phase.py: no CUDA device is available", file=sys.stderr)
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
    t0 = time.perf_counter()
    cs.steps_phase(torch, np)
    print(f"phase steps: {time.perf_counter() - t0:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
