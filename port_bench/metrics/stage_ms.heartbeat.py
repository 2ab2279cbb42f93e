"""Device time of the kernels launched inside the heartbeat stage's spans
(record_function around the engine's stage functions, eager ticks), per
tick, in ms; nothing where the stage never ran."""


def read(ctx):
    s = (ctx.get("trace") or {}).get("stages")
    if not s or "heartbeat" not in s["stage_us"]:
        return None
    return s["stage_us"]["heartbeat"] / 1e3 / s["ticks"]
