"""Median over the window's steps of the summed AdamW device time of the
step's minibatches (``PPOTrainer.timings["optimizer"]``, ``optim/adam.py``)."""
import statistics


def read(ctx):
    t = [sum(s["optimizer"]) for s in (ctx.get("window") or {}).get("timings", [])
         if s.get("optimizer")]
    return 1e3 * statistics.median(t) if t else None
