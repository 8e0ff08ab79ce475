"""Seconds inside the program's ``setup.system`` span: ``System``'s
construction, with the warm-ups it runs."""

from benchmark.harness import program_trace

read = program_trace.READERS["setup.system_s"]
