"""Device milliseconds launched inside the program's ``advect`` spans
(advection, collision, the next dt, and a retry's re-advance), by
correlation id; per substep of the traced segment
(:mod:`benchmark.progtrace`)."""

from benchmark import progtrace


def read(ctx):
    return progtrace.stage_device_ms(ctx, ("advect",))
