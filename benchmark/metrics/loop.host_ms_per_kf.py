"""Host ms a loop-closer call: the program's ``loop`` spans of the
window's keyframes (BoW scoring, DetectLoop, and a verification or a
correction where one comes), over their number."""

from benchmark.harness import program_trace

read = program_trace.READERS["loop.host_ms_per_kf"]
