"""Host ms a window frame inside the program's ``system.upload`` spans
(``System._upload``: the frame's images to the device)."""

from benchmark.harness import program_trace

read = program_trace.READERS["system.upload.host_ms"]
