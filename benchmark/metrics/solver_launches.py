"""The work the scan solver queues on the card, in launches a traced call:
the window thread's CUDA runtime calls ``cudaLaunchKernel*``,
``cudaMemcpy*`` and ``cudaMemset*`` that start inside the port's
``ikpso.solve`` spans, over the traced calls (``benchmark/core/spans.py``)."""

from benchmark.core import spans


def read(ctx):
    from ikpso_tpu_torch.utils import profiling

    got = spans.window_spans(ctx, getattr(profiling, "spans", list)())
    if got is None:
        return None
    return sum(spans.enqueues_by_call(ctx.trace, got).values()) / ctx.trace.calls
