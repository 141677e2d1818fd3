"""Device milliseconds launched inside the program's ``refine`` span of a
rebuild substep (the block lists refined to candidate subblocks), by
correlation id; the mean over the traced segment's rebuilds
(:mod:`benchmark.progtrace`)."""

from benchmark import progtrace


def read(ctx):
    return progtrace.stage_device_ms(ctx, ("refine",), "rebuild")
