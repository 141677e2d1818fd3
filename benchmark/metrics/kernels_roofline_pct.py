"""The least time the problem's density and force work could take
(:func:`benchmark.peaks.least_seconds`, on the pairs within h that the
reference counted in the checked substeps) over the device time of the
kernels that do it, in the profiled segment; percent."""

from benchmark import devtrace, peaks

# the device functions of the density and force passes
KERNELS = ("density_rows_kernel", "density_gated", "forces_q32_kernel",
           "forces_rows_c32_kernel", "forces_stream_kernel")


def read(ctx):
    tr, pairs = ctx.get("trace"), ctx.get("pairs_per_substep")
    if tr is None or not pairs:
        return None
    t = devtrace.op_time(tr, KERNELS) * 1e-6
    if t <= 0:
        return None
    n = ctx["params"].n
    return 100.0 * peaks.least_seconds(n, pairs) * ctx["trace_substeps"] / t
