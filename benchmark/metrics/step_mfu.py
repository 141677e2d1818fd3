"""The whole substep's share of the card's float32 peak: the problem's
density and force operations (the pairs within h the reference counted,
:mod:`benchmark.peaks`) over the profiled segment's wall time; percent.
It bounds every kernel roofline share of the same segment."""

from benchmark import peaks


def read(ctx):
    tr, pairs = ctx.get("trace"), ctx.get("pairs_per_substep")
    if tr is None or not pairs:
        return None
    seconds = (tr.window[1] - tr.window[0]) * 1e-6
    ops = pairs * (peaks.DENSITY_OPS + peaks.FORCE_OPS) * ctx["trace_substeps"]
    return 100.0 * ops / (seconds * peaks.FP32_FLOPS)
