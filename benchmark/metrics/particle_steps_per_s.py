"""Particles times substeps completed in the window, over the window's
wall time (which ends in a device synchronise)."""


def read(ctx):
    w = ctx["window"]
    return w["work"] / w["elapsed"] if w.get("work") else None
