"""Device time of every operation in the traced supervised stretch, over
its ticks, in ms."""


def read(ctx):
    s = (ctx.get("trace") or {}).get("stretch")
    if not s or not s["device_us"]:
        return None
    return sum(s["device_us"].values()) / 1e3 / s["ticks"]
