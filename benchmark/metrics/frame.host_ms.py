"""Host ms per frame inside the frame pipeline (`make_rgbd` or `_make_stereo`)."""

from benchmark.harness import spans as _spans


def read(run):
    if run.spans is None or not run.n_window:
        return None
    calls = _spans.in_window(run, "frame")
    return _spans.total_ms(run, "frame") / run.n_window if calls else None
