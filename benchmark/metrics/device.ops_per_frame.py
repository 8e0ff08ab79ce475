"""Device operations (kernels, copies, fills) per frame of the traced
stretch, from ``torch.profiler``."""


def read(run):
    p = run.profile
    if not p or not p["ops"]:
        return None
    return p["ops"] / p["frames"]
