"""1 - (union of the device's kernel, copy and fill intervals) / (the
traced stretch's wall time), from ``torch.profiler`` over a stretch of
whole frames after the window."""


def read(run):
    p = run.profile
    if not p or p["busy_us"] <= 0:
        return None
    return 1.0 - p["busy_us"] / p["stretch_us"]
