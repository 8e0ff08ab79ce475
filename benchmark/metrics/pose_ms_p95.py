"""95th percentile over the window's frames of the time from handing a
frame in to its pose being complete on the device (ms)."""

import numpy as np


def read(run):
    if len(run.latency_ms) == 0:
        return None
    return float(np.percentile(run.latency_ms, 95))
