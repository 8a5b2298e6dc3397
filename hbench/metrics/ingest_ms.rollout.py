"""Median host time of one chunk of chunked ingest over the traced run's
window, from the program's ``engine.ingest`` spans (``core/rollout.py``)."""
import statistics


def read(ctx):
    d = ctx.get("spans", {}).get("engine.ingest")
    return 1e3 * statistics.median(d) if d else None
