"""The nearest-rank 90th percentile of every frame's time in the window:
from the end of the previous frame's save to the end of its own, on the
benchmark's clock (the first frame of a segment from the save of its
start)."""

import math


def read(ctx):
    v = sorted(ctx["window"].get("intervals") or [])
    return v[max(0, math.ceil(0.9 * len(v)) - 1)] if v else None
