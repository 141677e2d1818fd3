"""Device milliseconds launched inside the program's ``sort`` and
``search`` spans of a rebuild substep (the padding, the Morton codes and
the re-sort, then the block bounds and the block search), by correlation
id; the mean over the traced segment's rebuilds (:mod:`benchmark.progtrace`)."""

from benchmark import progtrace


def read(ctx):
    return progtrace.stage_device_ms(ctx, ("sort", "search"), "rebuild")
