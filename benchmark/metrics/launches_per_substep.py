"""Device operations (kernels, copies, sets) launched inside the
program's ``substep`` spans, by correlation id; per substep of the traced
segment (:mod:`benchmark.progtrace`)."""

from benchmark import progtrace


def read(ctx):
    tr, prog = ctx.get("trace"), progtrace.load(ctx, "dispatch")
    if prog is None or not tr.ops:
        return None
    subs = progtrace.named(prog, "substep")
    _, ops = progtrace.launched(tr, prog)
    return sum(ops.get(s.id, 0) for s in subs) / len(subs) if subs else None
