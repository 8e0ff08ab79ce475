"""Host ms per frame inside the tracking step (`track_step`)."""

from benchmark.harness import spans as _spans


def read(run):
    if run.spans is None or not run.n_window:
        return None
    calls = _spans.in_window(run, "track")
    return _spans.total_ms(run, "track") / run.n_window if calls else None
