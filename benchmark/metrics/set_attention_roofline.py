"""Share of the set-attention kernel's roofline (%): the least time the
card could take for the traced frames' set attention
(benchmark/work.py:set_attention_seconds: live sets' q, k, v read and
the output written once at bf16, or the products at 989 TFLOP/s) over the
device time of the kernels named in KERNELS in the traced window."""

KERNELS = ("set_attention_kernel",)


def read(ctx):
    trace = ctx["trace"]
    if ctx["mode"] != "stream" or trace is None:
        return None
    spent = trace.kernel_s(KERNELS)
    if spent <= 0:
        return None
    return ctx["set_attention_s"] / spent * 100.0
