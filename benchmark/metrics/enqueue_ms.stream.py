"""Host ms a frame of the ``Engine`` call in the stream loop (copy-in and
the graph's launch), the mean of the harness's ``enqueue`` spans over the
measured window."""

MODE = "stream"


def read(ctx):
    spans = ctx["spans"].get("enqueue")
    if ctx["mode"] != MODE or not spans:
        return None
    return sum(spans) / len(spans) * 1e3
