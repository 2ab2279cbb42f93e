"""Device time of the hand-written kernels (each file of port_bench/
roofline names one) in the traced supervised stretch, per tick, in ms;
nothing where none ran."""

from port_bench import roofline


def read(ctx):
    s = (ctx.get("trace") or {}).get("stretch")
    if not s:
        return None
    us = sum(roofline.kernel_us(s["device_us"], m.KERNEL)
             for m in roofline.modules().values())
    return us / 1e3 / s["ticks"] if us > 0 else None
