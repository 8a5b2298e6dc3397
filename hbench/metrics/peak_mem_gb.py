"""Peak device memory of the run, ``torch.cuda.max_memory_allocated``
after ``reset_peak_memory_stats`` at the start of set-up, read before the
reference runs."""


def read(ctx):
    b = ctx.get("peak_bytes")
    return b / 1e9 if b else None
