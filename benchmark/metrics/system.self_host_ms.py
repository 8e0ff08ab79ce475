"""Host ms a window frame inside the program's ``system.track`` root
span, less the spans of the layers it ran there (``frame``, ``track``,
``mapping``, ``loop``)."""

from benchmark.harness import program_trace

read = program_trace.READERS["system.self_host_ms"]
