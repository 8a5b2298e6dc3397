"""The device trace of a traced run: ``torch.profiler`` over a short window
after the measured one, kept in memory.

``Traced`` profiles the calls made inside it; the harness marks its own
host spans (``span``: ``admit``, ``engine.step``, ``prepare``,
``train_step``) as profiler ranges, so the idle gaps on the device can be
laid against what the host was doing.  ``summary`` returns every device
operation's interval, the busy time (the union of the intervals), the
window, the operations that took most time and the idle time by host
span.
"""
from __future__ import annotations

import re
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional, Tuple

import torch

from hbench import stats

WINDOW = "hb:window"
_active: Optional["Traced"] = None


def span(name: str):
    """A host span of the harness: a profiler range while tracing."""
    if _active is None:
        return nullcontext()
    return torch.profiler.record_function("hb:" + name)


def short_name(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    name = re.sub(r"^void ", "", name)
    out, depth = [], 0
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:80] or name[:80]


class Traced:
    def __init__(self):
        self.prof = None
        self.window_s = 0.0

    @contextmanager
    def window(self):
        global _active
        from torch.profiler import ProfilerActivity, profile
        cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        sync = torch.cuda.synchronize if cuda else (lambda: None)
        sync()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        _active = self
        try:
            with torch.profiler.record_function(WINDOW):
                t0 = time.perf_counter()
                yield self
                sync()
                self.window_s = time.perf_counter() - t0
        finally:
            _active = None
            self.prof.__exit__(None, None, None)

    def summary(self) -> Dict:
        dev = torch.autograd.DeviceType.CUDA
        ops: List[Tuple[str, float, float]] = []
        host: List[Tuple[str, float, float]] = []
        w0 = w1 = None
        for e in self.prof.events():
            a, b = float(e.time_range.start), float(e.time_range.end)
            if e.name.startswith("hb:"):
                # the harness's ranges; the profiler also lays them on the
                # device's timeline, where they are no device operation
                if e.device_type == dev:
                    continue
                if e.name == WINDOW:
                    w0, w1 = a, b
                else:
                    host.append((e.name[3:], a, b))
            elif e.device_type == dev:
                ops.append((e.name, a, b))
        if not ops:
            return {}
        ops.sort(key=lambda x: x[1])
        if w0 is None:
            w0, w1 = ops[0][1], ops[-1][2]
        busy, gaps = stats.busy_and_gaps([(a, b) for _, a, b in ops], w0, w1)
        by_op: Dict[str, float] = defaultdict(float)
        for n, a, b in ops:
            by_op[short_name(n)] += (b - a) / 1e6
        idle: Dict[str, float] = defaultdict(float)
        for a, b in gaps:
            mid = 0.5 * (a + b)
            inside = [h for h in host if h[1] <= mid <= h[2]]
            label = max(inside, key=lambda h: h[1])[0] if inside else "harness"
            idle[label] += (b - a) / 1e6
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        return {"ops": ops, "busy_s": busy / 1e6, "window_s": (w1 - w0) / 1e6,
                "device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:10]]}
