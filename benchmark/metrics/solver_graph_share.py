"""The share of the traced window's scan-solver calls that replayed a CUDA
graph: the port's ``ikpso.solve`` spans holding an ``ikpso.solve.replay``
child, over every ``ikpso.solve`` span of the window
(``benchmark/core/spans.py``); 0 where no call replayed. None where the
window holds no ``ikpso.solve`` span."""

from benchmark.core import spans

REPLAY = "ikpso.solve.replay"


def read(ctx):
    from ikpso_tpu_torch.utils import profiling

    got = spans.window_spans(ctx, getattr(profiling, "spans", list)())
    if got is None:
        return None
    calls = {call for _, _, _, call in spans.roots(got)}
    replayed = {call for name, _, _, call in got if name == REPLAY}
    return len(calls & replayed) / len(calls)
