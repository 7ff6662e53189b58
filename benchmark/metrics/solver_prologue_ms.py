"""The host's work in the scan solver before its first step launch, in ms
a traced call: the port's ``ikpso.solve.pack`` (kernel C's packing) and
``ikpso.solve.init`` (the swarm's init) spans, summed, over the traced
calls (``benchmark/core/spans.py``)."""

from benchmark.core import spans


def read(ctx):
    from ikpso_tpu_torch.utils import profiling

    got = spans.window_spans(ctx, getattr(profiling, "spans", list)())
    if got is None:
        return None
    return 1e3 * spans.prologue_s(got) / ctx.trace.calls
