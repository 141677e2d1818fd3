"""Process start to the first timed operation, seconds."""


def read(ctx):
    return ctx["setup_s"]
