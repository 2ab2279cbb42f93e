"""The program's own pricing of its stored state,
sim/state.state_nbytes(cfg)["total"], in GiB."""


def read(ctx):
    return ctx["state_nbytes"] / 2 ** 30
