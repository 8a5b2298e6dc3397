"""Share of its roofline that the flash attention kernels
(``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``) reach
over the profiled train step: the least time of every launch (each input
byte read and each output byte written once, the operations of visible
pairs within each packed sequence) over their device time."""
import re

from hbench import roofline

# the forward's kernel, and every kernel of csrc/flash_attention_bwd.cu
# (bwd_prep_kernel, bwd_dkdv_kernel, bwd_reduce_kernel, bwd_dq_kernel,
# tc::bwd_kernel)
KERNEL = re.compile(r"flash_fwd\w*kernel|\bbwd_\w*kernel")


def read(ctx):
    prof = ctx.get("profile") or {}
    ops = prof.get("ops", [])
    t = sum(b - a for n, a, b in ops if KERNEL.search(n)) / 1e6
    launches = prof.get("launches", {})
    mbs = prof.get("lengths") or []
    if not t or not mbs:
        return None
    cfg = ctx["cfg"]
    fwd = sum(roofline.flash_forward(cfg, m) for m in mbs) / len(mbs)
    bwd = sum(roofline.flash_backward(cfg, m) for m in mbs) / len(mbs)
    bound = launches.get("flash_attention", 0) * fwd + launches.get("flash_attention_bwd", 0) * bwd
    return 100.0 * bound / t if bound else None
