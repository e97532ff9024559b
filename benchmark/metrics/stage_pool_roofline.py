"""Share of the pooling kernel's roofline (%): the least time of the
traced frames' pooling attentions (benchmark/work_voxel.py:
stage_pool_seconds: the children's key and value rows, the parents' query
and output rows moved once at bf16) over the device time of the kernels
named in KERNELS in the traced window."""

KERNELS = ("stage_pool_kernel",)


def read(ctx):
    trace = ctx["trace"]
    if ctx["mode"] != "stream" or trace is None or "stage_pool_s" not in ctx:
        return None
    spent = trace.kernel_s(KERNELS)
    if spent <= 0:
        return None
    return ctx["stage_pool_s"] / spent * 100.0
