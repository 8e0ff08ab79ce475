"""Global bundle adjustment in the point-major layout (single device)."""
