"""The model's operations of the traced frames (benchmark/work.py, from
the configuration's widths and each frame's counts) over the traced
window's time on the card, against the bf16 peak (989 TFLOP/s) (%)."""

MODE = "stream"


def read(ctx):
    trace = ctx["trace"]
    if ctx["mode"] != MODE or trace is None or not trace.window_s():
        return None
    return ctx["flops"] / trace.window_s() / ctx["peak_flops"] * 100.0
