"""Share of each traced sweep's own span on the card (its first device
event to its last) in which nothing ran, over all traced sweeps (%).
Between sweeps the card waits for the sensor by design; that is left
out."""

MODE = "sensor"


def read(ctx):
    trace = ctx["trace"]
    if ctx["mode"] != MODE or trace is None:
        return None
    busy = window = 0.0
    for k in range(trace.n_spans("frame")):
        events = trace.in_span("frame", k)
        busy += trace.busy_s(events)
        window += trace.window_s(events)
    return (1.0 - busy / window) * 100.0 if window else None
