"""Host syncs of the traced supervised stretch per tick: host reads of
device values (aten::_local_scalar_dense) and synchronizing runtime calls,
less those of an empty profiled window."""


def read(ctx):
    s = (ctx.get("trace") or {}).get("stretch")
    return s["syncs"] / s["ticks"] if s else None
