"""The frame loop's host reads (``engine.step.host_read.count``) over the
substeps it ran in the window: those the reference counted a frame, for
every frame, plus the ones thrown away."""


def read(ctx):
    w = ctx["window"]
    per_frame = ctx.get("substeps_per_frame")
    if not w.get("frames") or not per_frame:
        return None
    return w["host_reads"] / (per_frame * w["frames"] + w["dispatch"]["wasted"])
