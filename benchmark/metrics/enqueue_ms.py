"""Host milliseconds a substep call takes to return (its launches
enqueued): the span around each call of the benchmark's ``run`` closure
that ``engine.step.dispatch`` drives."""


def read(ctx):
    s = ctx["spans"].get("enqueue")
    return 1e3 * sum(s) / len(s) if s else None
