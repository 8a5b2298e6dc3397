"""Median over the window's steps of the summed forward and backward
device time of the step's micro-batches (``PPOTrainer.timings["fwd_bwd"]``)."""
import statistics


def read(ctx):
    t = [sum(s["fwd_bwd"]) for s in (ctx.get("window") or {}).get("timings", [])
         if s.get("fwd_bwd")]
    return 1e3 * statistics.median(t) if t else None
