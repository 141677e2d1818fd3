"""Milliseconds a frame's save takes on the saver thread: the span
around the benchmark's ``save_frame`` call into the port's
``HoudiniFileSaver.write_frame_to_file``."""


def read(ctx):
    s = ctx["spans"].get("export")
    return 1e3 * sum(s) / len(s) if s else None
