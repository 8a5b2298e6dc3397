"""Share of its roofline that the paged decode kernel
(``kernels/ops.py`` -> ``csrc/paged_decode_attention.cu``) reaches over the
profiled steps: the least time the steps' decode attention needs (each
pool block that a decoding slot reads, read once; each query and output
once; the operations of every visible key), summed over the kernel's
launches, over the device time of the kernel's launches."""
from hbench import roofline

KERNEL = "paged_decode_kernel"


def read(ctx):
    prof = ctx.get("profile") or {}
    t = sum(b - a for n, a, b in prof.get("ops", []) if KERNEL in n) / 1e6
    shapes = [s for s in prof.get("decode_shapes", []) if s and s["contexts"]]
    launches = prof.get("launches", {}).get("paged_decode_attention", 0)
    if not t or not shapes or not launches:
        return None
    per_step = [roofline.paged_decode(ctx["cfg"], s["contexts"], s["blocks"], s["block_size"])
                for s in shapes]
    bound = launches * sum(per_step) / len(per_step)
    return 100.0 * bound / t
