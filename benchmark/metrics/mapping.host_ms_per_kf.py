"""Host ms per keyframe-mapping call (`keyframe_mapping`)."""

from benchmark.harness import spans as _spans


def read(run):
    if run.spans is None:
        return None
    calls = _spans.in_window(run, "mapping")
    return _spans.total_ms(run, "mapping") / len(calls) if calls else None
