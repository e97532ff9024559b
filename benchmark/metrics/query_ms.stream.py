"""Device ms a frame under the port's ``query`` label (the TransFusion-L
head's decoder and branches, the cross-attention kernel among them, nested
in ``head``), from a trace of ``Engine.eager`` on the cell's first
sweeps."""


def read(ctx):
    stages = ctx.get("stages")
    if ctx["mode"] != "stream" or not stages or not stages.get("query"):
        return None
    return stages["query"]
