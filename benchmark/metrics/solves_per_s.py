"""Solves per second: the answers the window returned (a batch's S
swarms) over the window's whole time (host clock)."""


def read(ctx):
    return ctx.window.solves / ctx.window.window_s
