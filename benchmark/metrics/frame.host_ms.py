"""Host ms a window frame inside the program's ``frame`` spans (the
frame pipeline: ``make_rgbd`` or ``_make_stereo``)."""

from benchmark.harness import program_trace

read = program_trace.READERS["frame.host_ms"]
