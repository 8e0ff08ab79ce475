"""SLAM models: frame, map arena, optimizer, tracking, System (PyTorch)."""
