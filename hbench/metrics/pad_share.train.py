"""Share of the window's packed micro-batch slots that hold padding
(``core/batching.py``, Algorithm 1): 1 - trained tokens / (micro-batches x
their token budget)."""


def read(ctx):
    w = ctx.get("window") or {}
    slots = sum(w.get("microbatches", [])) * w.get("pack_len", 0)
    return 100.0 * (1.0 - sum(w["tokens"]) / slots) if slots else None
