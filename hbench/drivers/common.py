"""What the drivers share: the port's model built from the configuration's
file with the harness's weights, the device record, and the program's
spans."""
from __future__ import annotations

import contextlib
import dataclasses
import gc
from collections import defaultdict
from typing import Dict, List, Optional

import torch

from hbench import weights


def build_kernels() -> None:
    """Compile (or find in the checkout's ``build/kernels``) every kernel
    of the port before anything is timed."""
    from repro_torch.kernels import build
    build.build()


def model_config(cfg: Dict):
    """The port's ``ModelConfig`` of the configuration's file."""
    from repro_torch.configs.base import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in cfg.items() if k in names})


def build_model(cfg: Dict, seed: int, device):
    from repro_torch.models.transformer import LM
    model = LM(model_config(cfg), device=device, dtype=getattr(torch, cfg["dtype"]))
    weights.load_into(model, cfg, seed)
    return model


@contextlib.contextmanager
def steady_window():
    """The measured window with Python's cyclic collector off: set-up's
    objects are frozen out of its generations and nothing is collected
    until the window closes, so that no run's window holds a pass over the
    engine's whole history that another run's does not."""
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.unfreeze()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def peak_bytes(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    return int(max(torch.cuda.max_memory_allocated(d) for d in range(torch.cuda.device_count())))


def device_record(device, peak: int, profile: Optional[Dict]) -> Dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
               "memory_peak_bytes": peak}
    else:
        rec = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    if profile and "busy_s" in profile:
        rec["busy_s"] = profile["busy_s"]
        rec["window_s"] = profile["window_s"]
    return rec


def breakdown(summary: Dict) -> Optional[Dict]:
    if not summary:
        return None
    return {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}


def span_durations(events: List[list]) -> Dict[str, List[float]]:
    """Seconds of each completed span of the program's tracer, by name."""
    out: Dict[str, List[float]] = defaultdict(list)
    for ev in events:
        if ev[0] == "X":
            out[ev[1]].append(float(ev[3]))
    return dict(out)


def reference_precision() -> None:
    """Products of the reference in float32 proper, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
