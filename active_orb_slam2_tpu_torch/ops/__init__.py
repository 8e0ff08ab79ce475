"""Vision ops: ORB extraction, matching, the fused pose optimization (PyTorch)."""
