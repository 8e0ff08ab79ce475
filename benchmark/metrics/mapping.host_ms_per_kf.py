"""Host ms a keyframe-mapping call: the program's ``mapping`` spans of
the window's keyframes, over their number."""

from benchmark.harness import program_trace

read = program_trace.READERS["mapping.host_ms_per_kf"]
