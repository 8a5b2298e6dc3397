"""One run of one cell: resolve it from ``BENCHMARK.json``, run its
traffic kind's driver, read its metrics, decide ``correct`` and print the
result line.

Everything a cell needs is found by name: its configuration's file (the
``file`` of its ``configs`` entry), its traffic mix
(``hbench/traffic/<traffic>.json``, whose ``kind`` names the driver in
``hbench/drivers/``), its limits (``hbench/limits/<cell>.json``) and each
per-layer metric's reader (``hbench/metrics/<metric>.py``, or one
reader of the quantity for every cell kind, a function ``read(ctx)`` that
returns a number or None).  A new cell or metric is new
files and entries, never an edit.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    """What a driver needs: the cell's name, the configuration's file as a
    dict, the traffic mix's parameters, the run's options and the limits
    of ``correct``."""
    name: str
    cfg: Dict
    traffic: Dict
    seed: int
    seconds: float
    trace: bool
    limits: Dict[str, float]
    device: str = "cuda"
    control: bool = False          # also read the control and the faults planted in it
    setup_t0: float = 0.0          # the clock at process start


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_bench(root: Path) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def resolve(root: Path, bench: Dict, workload: str) -> Dict:
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def of(metric):
        return "workloads" not in metric or workload in metric["workloads"]

    return {"workload": w,
            "cfg": json.loads((root / conf["file"]).read_text()),
            "traffic": json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
            "limits": json.loads((HERE / "limits" / f"{workload}.json").read_text()),
            "end_to_end": [m for m in bench["end_to_end"] if of(m)],
            "per_layer": [m for m in bench["per_layer"] if of(m)]}


def driver(kind: str):
    return importlib.import_module(f"hbench.drivers.{kind}")


def reader_path(metric: str) -> Path:
    """``metrics/<metric>.py``, or for a metric split by cell kind
    (``idle_share.train``) the quantity's one reader, ``metrics/idle_share.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists() and "." in metric:
        path = HERE / "metrics" / f"{metric.rsplit('.', 1)[0]}.py"
    return path


def reader(metric: str) -> Callable[[Dict], Optional[float]]:
    path = reader_path(metric)
    spec = importlib.util.spec_from_file_location(f"hbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit; a missing or non-finite
    reading fails."""
    return {k: {"value": readings.get(k, math.nan), "limit": float(lim)}
            for k, lim in limits.items()}


def is_correct(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())


def result_line(spec: Dict, run: Dict, trace: bool) -> Dict:
    metrics = {}
    if trace:
        for m in spec["per_layer"]:
            v = reader(m["name"])(run["ctx"])
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            if m["name"] in run["end_to_end"]:
                metrics[m["name"]] = {"value": float(run["end_to_end"][m["name"]]),
                                      "unit": m["unit"]}
    out = {"correct": bool(run["correct"]), "attempted": int(run["attempted"]),
           "failed": int(run["failed"]), "metrics": metrics, "device": run["device"]}
    if trace and run.get("breakdown"):
        out["breakdown"] = run["breakdown"]
    out["checks"] = run["checks"]
    return out


def run_cell(cell: Cell) -> Dict:
    """Run the cell's driver; returns its run record (``end_to_end``,
    ``ctx`` for the readers, ``readings``, ``attempted``, ``failed``,
    ``device``, ``breakdown``) with ``checks`` and ``correct`` added."""
    run = driver(cell.traffic["kind"]).run(cell)
    run["checks"] = judge(run["readings"], cell.limits)
    run["correct"] = is_correct(run["checks"]) and run["failed"] == 0
    return run
