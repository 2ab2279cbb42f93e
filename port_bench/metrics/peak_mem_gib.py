"""torch.cuda.max_memory_reserved() over set-up and window, graph pools
included, in GiB; nothing without a card."""


def read(ctx):
    peak = ctx["window"]["peak_bytes"]
    return peak / 2 ** 30 if peak else None
