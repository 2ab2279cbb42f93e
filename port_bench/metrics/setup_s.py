"""Process start to the window's start (host clock): imports, the
kernels' builds or loads, the underlay, the state, the warm-up chunks and
the capture of the cell's chunk."""


def read(ctx):
    return ctx["window"]["setup_s"]
