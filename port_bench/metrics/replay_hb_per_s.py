"""Heartbeats per second of chained replays of the cell's captured chunk
with no supervisor around them, timed by CUDA events; its gap to hb_per_s
is what the supervised plane costs."""


def read(ctx):
    r = (ctx.get("trace") or {}).get("replay")
    return r["ticks"] / (r["ms"] / 1e3) if r and r["ms"] > 0 else None
