"""The 95th percentile of every frame's wall in the window, in ms: the
frame's solve to its errors on the host (host clock; numpy's linear
percentile)."""

import numpy as np


def read(ctx):
    return float(np.percentile(np.asarray(ctx.window.call_s) * 1e3, 95))
