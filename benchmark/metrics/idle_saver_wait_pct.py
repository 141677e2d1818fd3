"""Share of the traced segment in which the device runs nothing while
the loop thread waits for the saver thread (the program's
``saver.wait`` span); percent (:mod:`benchmark.progtrace`)."""

from benchmark import progtrace


def read(ctx):
    return progtrace.idle_pct(ctx, "simulate", "saver.wait")
