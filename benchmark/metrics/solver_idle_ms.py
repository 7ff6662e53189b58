"""How long the card waited on the scan solver's host code, in ms a traced
call: the device's idle gaps inside the port's ``ikpso.solve`` spans
(``benchmark/core/spans.py``), summed, over the traced calls."""

from benchmark.core import spans


def read(ctx):
    from ikpso_tpu_torch.utils import profiling

    got = spans.window_spans(ctx, getattr(profiling, "spans", list)())
    if got is None or not ctx.trace.device:
        return None
    return 1e3 * spans.solver_idle_s(ctx.trace, got) / ctx.trace.calls
