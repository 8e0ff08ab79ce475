"""Host ms per loop-closer call (``loop_closer.process_keyframe``): the
BoW scoring, DetectLoop, and a verification or a correction where one
comes."""

from benchmark.harness import spans as _spans


def read(run):
    if run.spans is None:
        return None
    calls = _spans.in_window(run, "loop")
    return _spans.total_ms(run, "loop") / len(calls) if calls else None
