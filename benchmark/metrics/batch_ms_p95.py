"""The 95th percentile of every batch's wall in the window, in ms: a
batch from its targets to its answers on the host (host clock; numpy's
linear percentile)."""

import numpy as np


def read(ctx):
    return float(np.percentile(np.asarray(ctx.window.call_s) * 1e3, 95))
