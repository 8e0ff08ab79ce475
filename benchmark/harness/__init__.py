"""The harness: definitions found by name, the run, spans, trace, check."""
