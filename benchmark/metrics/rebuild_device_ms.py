"""Device milliseconds of the work launched inside each rebuild substep's
call (a re-sort and the candidate machinery, then the passes), followed
by the profiler's correlation from each launch to its device operation;
the mean over the profiled segment's rebuilds."""

from benchmark import devtrace


def read(ctx):
    tr = ctx.get("trace")
    per = devtrace.device_time_by_range(tr, "rebuild") if tr else []
    return 1e-3 * sum(per) / len(per) if per and sum(per) > 0 else None
