"""Device ms a frame under the port's ``pool`` label (the attention
pooling between the stages of a staged backbone, nested in
``backbone3d``), from a trace of ``Engine.eager`` on the cell's first
sweeps."""


def read(ctx):
    stages = ctx.get("stages")
    if ctx["mode"] != "stream" or not stages or not stages.get("pool"):
        return None
    return stages["pool"]
