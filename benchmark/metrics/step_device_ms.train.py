"""Device busy ms a training step: the union of the traced steps' device
events over the number of steps."""

MODE = "train"


def read(ctx):
    trace = ctx["trace"]
    if ctx["mode"] != MODE or trace is None or not ctx.get("steps"):
        return None
    return trace.busy_s() / ctx["steps"] * 1e3
