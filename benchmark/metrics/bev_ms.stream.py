"""Device ms a frame under the port's ``backbone2d`` and ``head`` stage
labels, from a trace of ``Engine.eager`` on the cell's first sweeps (the
labels do not fire inside a graph replay)."""

STAGES = ("backbone2d", "head")


def read(ctx):
    stages = ctx.get("stages")
    if ctx["mode"] != "stream" or not stages:
        return None
    return sum(stages[s] for s in STAGES)
