"""Device milliseconds launched inside the program's ``passes`` spans (the
stale check, the packs, the density kernel, hit compaction, pressure and
the force kernel), by correlation id; per substep of the traced segment
(:mod:`benchmark.progtrace`)."""

from benchmark import progtrace


def read(ctx):
    return progtrace.stage_device_ms(ctx, ("passes",))
