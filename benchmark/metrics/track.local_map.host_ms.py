"""Host ms a window frame inside the program's ``track.local_map``
spans (``track_step``'s T2: the fallback, the local-keyframe vote, the
frustum cull, local-map matching, and the second K1 launch)."""

from benchmark.harness import program_trace

read = program_trace.READERS["track.local_map.host_ms"]
