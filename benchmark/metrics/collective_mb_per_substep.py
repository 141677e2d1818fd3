"""Megabytes of collectives arriving on rank 0 (``Mesh.read_stats``'
bytes, every collective) per substep of the window."""


def read(ctx):
    w = ctx["window"]
    b = w.get("collective_bytes")
    return b / w["substeps"] / 1e6 if b is not None and w.get("substeps") else None
