"""Median host time of the engine's step over the traced run's window,
from the program's ``engine.step`` spans (``core/rollout.py``)."""
import statistics


def read(ctx):
    d = ctx.get("spans", {}).get("engine.step")
    return 1e3 * statistics.median(d) if d else None
