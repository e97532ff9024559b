"""Device ms a frame under the port's ``voxelize``, ``vfe``,
``partition`` and ``backbone3d`` stage labels, from a trace of
``Engine.eager`` on the cell's first sweeps."""

STAGES = ("voxelize", "vfe", "partition", "backbone3d")


def read(ctx):
    stages = ctx.get("stages")
    if ctx["mode"] != "stream" or not stages:
        return None
    return sum(stages[s] for s in STAGES)
