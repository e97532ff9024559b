"""Share of the encoder-epilogue kernel's roofline (%): the least time for
the traced frames' out-projections, FFNs and LayerNorms on the live
pillar rows (benchmark/work.py:encoder_epilogue_seconds) over the device
time of the kernels named in KERNELS in the traced window."""

KERNELS = ("encoder_epilogue_kernel",)


def read(ctx):
    trace = ctx["trace"]
    if ctx["mode"] != "stream" or trace is None:
        return None
    spent = trace.kernel_s(KERNELS)
    if spent <= 0:
        return None
    return ctx["encoder_epilogue_s"] / spent * 100.0
