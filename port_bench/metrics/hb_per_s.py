"""Heartbeats of the window over its whole wall time (host clock, from
the supervised run's call to its return, after the last chunk is
confirmed on the host and the journal drained)."""


def read(ctx):
    w = ctx["window"]
    return w["ticks"] / w["seconds"]
