"""The benchmark's tests, on the CPU (``cuda``-marked cases on the card)."""
