"""Host ms a sweep of the ``Engine`` call in the sensor loop (the copy-in
from pageable memory and the graph's launch), the mean of the harness's
``enqueue`` spans over the measured window."""

MODE = "sensor"


def read(ctx):
    spans = ctx["spans"].get("enqueue")
    if ctx["mode"] != MODE or not spans:
        return None
    return sum(spans) / len(spans) * 1e3
