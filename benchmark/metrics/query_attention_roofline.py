"""Share of the cross-attention kernel's roofline (%): the least time of
the traced frames' cross-attentions (benchmark/work_query.py:
query_attention_seconds: the key and value projections of every cell, Q.K^T
and P.V at 989 TFLOP/s, or L and Pk read once at 3.35 TB/s, whichever is
longer) over the device time of the kernels whose names hold KERNELS in
the traced window (the attention and the combine of its partials)."""

KERNELS = ("query_attention",)


def read(ctx):
    trace = ctx["trace"]
    if ctx["mode"] != "stream" or trace is None \
            or "query_attention_s" not in ctx:
        return None
    spent = trace.kernel_s(KERNELS)
    if spent <= 0:
        return None
    return ctx["query_attention_s"] / spent * 100.0
