"""Share of the traced training steps, from the first device event to the
last, in which no kernel, copy or memset ran on the card (%)."""

MODE = "train"


def read(ctx):
    trace = ctx["trace"]
    if ctx["mode"] != MODE or trace is None or not trace.window_s():
        return None
    return (1.0 - trace.busy_s() / trace.window_s()) * 100.0
