"""Host ms a window frame inside the program's ``track`` spans (the
tracking step, ``track_step``)."""

from benchmark.harness import program_trace

read = program_trace.READERS["track.host_ms"]
