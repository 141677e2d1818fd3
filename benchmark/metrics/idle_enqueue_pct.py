"""Share of the traced segment in which the device runs nothing while
the loop thread is inside a program ``substep`` span (enqueueing its
launches); percent (:mod:`benchmark.progtrace`)."""

from benchmark import progtrace


def read(ctx):
    return progtrace.idle_pct(ctx, "dispatch", "substep")
