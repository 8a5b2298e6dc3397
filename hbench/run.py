"""The benchmark of the PyTorch port: one run of one cell.

    python3 hbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It puts the checkout's ``src`` on the path,
keeps the port's build caches inside the checkout (``build/``), refuses to
run without enough CUDA devices, and prints one JSON line last on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number compared
for ``correct`` beside its limit, which also end standard error.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
# one process with few threads: the program's host path is one Python
# thread feeding the card, and pools of idle CPU workers only add jitter
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="also read the lower-precision control and the planted faults "
                         "(for setting limits; the benchmark's runs leave it off)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from hbench import harness
    spec = harness.resolve(ROOT, harness.load_bench(ROOT), args.workload)
    import torch
    torch.set_num_threads(1)
    need = int(spec["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"hbench: the cell needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    cell = harness.Cell(name=args.workload, cfg=spec["cfg"], traffic=spec["traffic"],
                        seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                        limits=spec["limits"], control=bool(args.control), setup_t0=T0)
    run = harness.run_cell(cell)
    found = harness.forbidden_modules()
    if found:
        print(f"hbench: JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    line = harness.result_line(spec, run, cell.trace)
    if run.get("extra"):
        print(json.dumps(run["extra"]), file=sys.stderr)
    for k, c in run["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
