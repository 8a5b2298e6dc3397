#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s whisper-medium and xlstm-1.3b phases alone on one NVIDIA H100.

    python3 tools/encdec_xlstm_phases.py [kernel] [small] [encdec] [xlstm] [train] [--profile]

Builds the kernels, then runs the named phases (all five by default),
each printing its JSON lines as the full script does: ``kernel``
(``encdec_kernel_phase``), ``small`` (``small_encdec_phase`` and
``small_xlstm_phase``), ``encdec`` (``serve_encdec_phase``, with its
part ``grad``), ``xlstm`` (``serve_xlstm_phase``; ``--profile`` traces
4 decode steps of its ring engines and times its block kinds) and
``train`` (``train_xlstm_phase``).  A phase that fails prints its
traceback and the script exits 1 after the others.
"""
from __future__ import annotations

import gc
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("encdec_xlstm_phases.py: no CUDA device is available", file=sys.stderr)
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
    phases = {"kernel": lambda: cs.encdec_kernel_phase(torch, np, False),
              "small": lambda: (cs.small_encdec_phase(torch, np),
                                cs.small_xlstm_phase(torch, np)),
              "encdec": lambda: cs.serve_encdec_phase(torch, np),
              "xlstm": lambda: cs.serve_xlstm_phase(torch, np, "--profile" in sys.argv),
              "train": lambda: cs.train_xlstm_phase(torch, np)}
    which = [a for a in sys.argv[1:] if not a.startswith("--")] or list(phases)
    unknown = [a for a in which if a not in phases]
    if unknown:
        print(f"encdec_xlstm_phases.py: unknown phases {unknown}; choose from {list(phases)}",
              file=sys.stderr)
        return 2
    ok = True
    for name in which:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
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
