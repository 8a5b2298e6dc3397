"""The window's share of the card's bf16 peak: 6 x the weights a token
multiplies by x the tokens trained, and three passes of the attention's
visible pairs, over the seconds of the window's steps (the proximal
recompute is not counted)."""
from hbench import roofline


def read(ctx):
    w = ctx.get("window") or {}
    if not w.get("step_s") or not w.get("lengths"):
        return None
    cfg = ctx["cfg"]
    pairs = roofline.causal_pairs(n for mb in w["lengths"][0] for n in mb)
    per_step = 3.0 * roofline.attention_flops_per_key(cfg) * pairs
    flops = 6.0 * roofline.matmul_params(cfg) * sum(w["tokens"]) + per_step * len(w["step_s"])
    return 100.0 * flops / sum(w["step_s"]) / roofline.PEAK_FLOPS
