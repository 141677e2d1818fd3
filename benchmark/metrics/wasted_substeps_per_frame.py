"""Substeps the frame loop ran and threw away (``dispatch_stats``'
``wasted``: chunks stopped on a stale or time predicate), per frame of
the window."""


def read(ctx):
    w = ctx["window"]
    return w["dispatch"]["wasted"] / w["frames"] if w.get("frames") else None
