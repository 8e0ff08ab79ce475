"""Seconds from process start to the window's first frame: traffic
made on the device, the System built with its warm-ups, the vocabulary
loaded, the kernels built or loaded, the warm-up frames."""


def read(run):
    return run.setup_s
