"""Share of the profiled window in which no operation ran on the card:
1 - the union of the device operations' intervals over the window."""


def read(ctx):
    prof = ctx.get("profile") or {}
    if not prof.get("window_s"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
