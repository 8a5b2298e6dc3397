#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 12 (the process fleet) alone on one NVIDIA H100.

    python3 tools/fleet_phase.py [--walls] [laptop] [laptop_1w] [kill] [full_width]

Builds the kernels, then runs the named parts of phase 12 (all four by
default) through ``chip_smoke.fleet_run``, each printing its JSON line
as the full script does.  With ``--walls`` it first runs phase 11's
``laptop`` and ``full_width`` parts (threaded, then ``run_serial``), so
that the fleet's walls are printed beside theirs from the same run.
A part that fails raises, as in ``chip_smoke.py``.  Worker processes are
spawned, so this file keeps its work under the ``__main__`` guard.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fleet_phase.py: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build

    args = [a for a in sys.argv[1:] if a != "--walls"]
    parts = cs.FLEET_PARTS
    unknown = [a for a in args if a not in parts]
    if unknown:
        print(f"fleet_phase.py: unknown parts {unknown}; choose from {list(parts)}",
              file=sys.stderr)
        return 2
    print(cs.nvidia_smi(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    walls = {}
    if "--walls" in sys.argv:
        cs.threaded_run(torch, "laptop", {}, serial_steps=cs.QUICKSTART["steps"], walls=walls)
        cs.threaded_run(torch, "full_width", dict(scale="pod", steps=cs.THREADED_STEPS_FULL),
                        serial_steps=cs.THREADED_STEPS_FULL, walls=walls)
    for part in args or list(parts):
        kw, strike = parts[part]
        t0 = time.perf_counter()
        rec, launches = cs.fleet_run(torch, part, kw, walls, strike=strike)
        cs.emit(rec)
        print(json.dumps({"part": part, "seconds": time.perf_counter() - t0,
                          "launches": launches}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
