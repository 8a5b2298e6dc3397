"""The 95th percentile over every sequence's gaps between consecutive
tokens in the traced run's window: a step of dt that gave n slots a token
gives n gaps of dt (``hbench/stats.py``).  Steps that also ingest a new
prompt sit in this tail, so it reads what chunked admission costs every
running sequence."""
import math


def read(ctx):
    v = (ctx.get("window") or {}).get("itl_p95_ms")
    return v if v is not None and math.isfinite(v) else None
