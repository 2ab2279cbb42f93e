"""100 less the union of device operations over the traced supervised
stretch's length, in %."""


def read(ctx):
    s = (ctx.get("trace") or {}).get("stretch")
    if not s or s["window_us"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_us"] / s["window_us"])
