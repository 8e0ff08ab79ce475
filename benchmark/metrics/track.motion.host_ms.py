"""Host ms a window frame inside the program's ``track.motion`` spans
(``track_step``'s T1 and the first K1 launch)."""

from benchmark.harness import program_trace

read = program_trace.READERS["track.motion.host_ms"]
