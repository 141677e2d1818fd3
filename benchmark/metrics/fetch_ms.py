"""Milliseconds of a frame's device-to-host copy on the saver thread (the
program's ``saver.fetch`` spans); the mean over the traced segment's
fetches (:mod:`benchmark.progtrace`)."""

from benchmark import progtrace


def read(ctx):
    prog = progtrace.load(ctx, "simulate")
    if prog is None:
        return None
    fetches = [s for s in progtrace.named(prog, "saver.fetch") if s.tid != prog.loop_tid]
    return 1e-3 * sum(s.end - s.start for s in fetches) / len(fetches) if fetches else None
