"""The hand-written kernels' share of their roofline in the traced
supervised stretch, in %: the sum over their launches of each launch's
least time (port_bench/roofline: its bytes at the card's peak bandwidth)
over their measured device time. The launches are those recorded when the
cell's chunk was captured; each replay in the stretch repeats them.
Nothing where no such kernel ran."""

from port_bench import roofline


def read(ctx):
    t = ctx.get("trace") or {}
    s, launches = t.get("stretch"), t.get("launches")
    if not s or not launches:
        return None
    mods = roofline.modules()
    replays = s["ticks"] / t["chunk_ticks"]
    rate = roofline.peaks()["hbm_bytes_per_s"]
    bound_s, labels = 0.0, set()
    for label, args in launches:
        if label in mods:
            bound_s += mods[label].nbytes(args) / rate * replays
            labels.add(label)
    measured_us = sum(roofline.kernel_us(s["device_us"], mods[x].KERNEL)
                      for x in labels)
    if measured_us <= 0:
        return None
    return 100.0 * bound_s / (measured_us * 1e-6)
