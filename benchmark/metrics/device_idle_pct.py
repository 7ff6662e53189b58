"""The share of the traced window in which no kernel and no copy ran on
the card (torch.profiler's device events), in %."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
