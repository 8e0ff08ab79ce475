"""Host ms per frame inside ``track_*``, less the spans of the layers it
called there (frame pipeline, tracking, local mapping, loop closing)."""

from benchmark.harness import spans as _spans


def read(run):
    if run.spans is None or not run.n_window:
        return None
    return _spans.self_ms(run, "system", ("frame", "track", "mapping",
                                          "loop")) / run.n_window
