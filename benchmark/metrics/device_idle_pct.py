"""Share of the profiled segment that no device operation (kernel, copy
or set) covers, from the union of their intervals; percent."""

from benchmark import devtrace


def read(ctx):
    tr = ctx.get("trace")
    return devtrace.idle_share(tr) if tr else None
