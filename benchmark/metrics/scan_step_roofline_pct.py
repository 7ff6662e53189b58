"""The scan step's share of its roofline, in %: the launches' summed
bound (``reference.counts.scan_step`` at the cell's S, P and D, the
larger of operations over 67 TFLOP/s and bytes over 3.35 TB/s) over
their summed device time. The launches are the kernels whose symbol
starts with one of ``SYMBOLS`` (``csrc/scan_step.cuh``)."""

from benchmark.core.trace import matching
from benchmark.reference import counts

SYMBOLS = ("scan_step_kernel",)


def read(ctx):
    if ctx.trace is None:
        return None
    launches = matching(ctx.trace.kernels(), SYMBOLS)
    if not launches:
        return None
    spent = sum(b - a for _, a, b in launches)
    bound = counts.bound_seconds(*counts.scan_step(
        ctx.config["counts"], ctx.dof, ctx.recipe, ctx.cell.swarms))
    return 100.0 * len(launches) * bound / spent
