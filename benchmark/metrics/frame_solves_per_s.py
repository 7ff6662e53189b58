"""Trial solves per second of the frame protocol: the trials' answers the
window returned (a frame's trials) over the window's whole time (host
clock). Kept apart from ``solves_per_s`` because a frame is paced by the
host as much as by the card, and its spread sets its own bound."""


def read(ctx):
    return ctx.window.solves / ctx.window.window_s
