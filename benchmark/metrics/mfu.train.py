"""Forward and backward operations of the traced steps' frames
(benchmark/work.py: 3 x the forward, every head branch on the full map)
over the traced window's time on the card, against the fp32 peak
(67 TFLOP/s) (%)."""

MODE = "train"


def read(ctx):
    trace = ctx["trace"]
    if ctx["mode"] != MODE or trace is None or not trace.window_s():
        return None
    return ctx["flops"] / trace.window_s() / ctx["peak_flops"] * 100.0
