"""Median over the window's steps of the proximal log-prob recompute's
device time (``PPOTrainer.timings["prox"]``, events on the stream)."""
import statistics


def read(ctx):
    t = [s["prox"] for s in (ctx.get("window") or {}).get("timings", []) if "prox" in s]
    return 1e3 * statistics.median(t) if t else None
