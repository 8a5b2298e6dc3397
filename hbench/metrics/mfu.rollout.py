"""The window's share of the card's bf16 peak: the model FLOPs of every
sampled token (2 x the weights it multiplies by, and 4 L H hd a key of its
context, at the window's mean context) over the window's seconds."""
import math

from hbench import roofline


def read(ctx):
    w = ctx.get("window") or {}
    if not w.get("tokens") or not math.isfinite(w.get("mean_context", math.nan)):
        return None
    cfg = ctx["cfg"]
    flops = w["tokens"] * (2.0 * roofline.matmul_params(cfg)
                           + roofline.attention_flops_per_key(cfg) * w["mean_context"])
    return 100.0 * flops / w["seconds"] / roofline.PEAK_FLOPS
