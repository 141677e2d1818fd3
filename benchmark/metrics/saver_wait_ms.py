"""Milliseconds the loop thread waits for the saver thread (the program's
``saver.wait`` spans, in ``AsyncSaver.join``) per frame of the traced
segment (:mod:`benchmark.progtrace`)."""

from benchmark import progtrace


def read(ctx):
    prog = progtrace.load(ctx, "simulate")
    if prog is None:
        return None
    frames = progtrace.named(prog, "frame")
    waits = progtrace.named(prog, "saver.wait", prog.loop_tid)
    return 1e-3 * sum(s.end - s.start for s in waits) / len(frames) if frames else None
