"""Host ms a window frame inside the program's ``system.wait`` spans:
the waits the program names (a retired frame's stats, a landed copy,
a synchronize)."""

from benchmark.harness import program_trace

read = program_trace.READERS["system.wait_ms"]
